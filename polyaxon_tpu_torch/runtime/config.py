"""The ``runtime:`` section of a job spec (port of
``polyaxon_tpu/runtime/config.py``, a dataclass instead of pydantic)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class RuntimeConfig:
    """Validated view of a job's ``runtime`` section, with the JAX
    package's fields and defaults. Unknown keys land in ``extras`` and are
    treated as model-config overrides (e.g. ``remat``, ``loss_chunk``),
    filtered against the model config's fields by ``model_overrides``."""

    model: str
    dataset: str = "lm_synthetic"
    steps: int = 100
    eval_every: Optional[int] = None
    eval_steps: int = 8
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    lr_schedule: str = "constant"  # constant | cosine | linear
    grad_clip_norm: Optional[float] = 1.0
    batch_size: Optional[int] = None          # per-device
    global_batch_size: Optional[int] = None   # overrides batch_size
    # Microbatches per update: gradients accumulate over this many
    # slices of the global batch (peak activations / grad_accum_steps).
    grad_accum_steps: int = 1
    seq_len: Optional[int] = None
    seed: int = 0
    log_every: int = 10
    # Batches generated (and pinned) ahead by a background thread.
    prefetch: int = 2
    # An XLA compilation cache directory in the JAX package; accepted for
    # spec compatibility and meaningless here (no XLA: eager PyTorch, and
    # the CUDA kernels' own build cache lives in ops/_build).
    compile_cache_dir: Optional[str] = None
    remat: Optional[str] = None
    attention_impl: Optional[str] = None
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Optional[list] = None
    profile_steps: Optional[list] = None
    extras: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.lora_alpha <= 0:
            raise ValueError(f"lora_alpha must be > 0, got {self.lora_alpha}")

    @classmethod
    def from_dict(cls, runtime: dict) -> "RuntimeConfig":
        if not isinstance(runtime, dict) or "model" not in runtime:
            raise ValueError("runtime section needs a `model`")
        names = {f.name for f in dataclasses.fields(cls)} - {"extras"}
        known = {k: v for k, v in runtime.items() if k in names}
        extras = {k: v for k, v in runtime.items() if k not in names}
        return cls(**known, extras=extras)

    def model_overrides(self, config_cls) -> dict[str, Any]:
        """Extra keys and the known knobs that match the model config's
        fields (``seq_len`` becomes ``max_seq_len``)."""
        fields = {f.name for f in dataclasses.fields(config_cls)}
        candidates = dict(self.extras)
        candidates.update({"remat": self.remat,
                           "attention_impl": self.attention_impl,
                           "max_seq_len": self.seq_len})
        return {k: v for k, v in candidates.items()
                if v is not None and k in fields}
