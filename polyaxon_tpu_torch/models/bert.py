"""BERT masked-LM pretraining model (port of ``polyaxon_tpu/models/bert.py``).

The encoder stack is ``models/encoder.py``'s at its default
``attention_impl="xla"`` (einsum attention): the reference's config does
not forward the field, so BERT reaches no flash kernel in either package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from polyaxon_tpu_torch.models import encoder
from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _w,
    cross_entropy_loss,
    gelu,
    layer_norm,
    scaled_init,
    tree_from_numpy,
    truncated_normal_init,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    dim: int = 1024          # bert-large
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: Any = torch.bfloat16
    remat: str = "none"

    def encoder_config(self) -> encoder.EncoderConfig:
        return encoder.EncoderConfig(
            dim=self.dim, n_layers=self.n_layers, n_heads=self.n_heads,
            ffn_dim=self.ffn_dim, dtype=self.dtype, remat=self.remat,
        )


CONFIGS: dict[str, BertConfig] = {
    "bert_large": BertConfig(),
    "bert_base": BertConfig(dim=768, n_layers=12, n_heads=12, ffn_dim=3072),
    "bert_tiny": BertConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                            ffn_dim=128, max_seq_len=64),
}


def init(cfg: BertConfig, generator: torch.Generator, *, device,
         param_dtype: torch.dtype = torch.float32) -> dict:
    D = cfg.dim
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape):
        return truncated_normal_init(shape, generator, device=device,
                                     dtype=param_dtype)

    params = {
        "tok_embed": normal(cfg.vocab_size, D),
        "pos_embed": normal(cfg.max_seq_len, D),
        "type_embed": normal(cfg.type_vocab_size, D),
        "embed_ln_scale": torch.ones((D,), **f32),
        "embed_ln_bias": torch.zeros((D,), **f32),
        "layers": encoder.init_layers(cfg.encoder_config(), generator,
                                      device=device, param_dtype=param_dtype),
        "mlm_dense": scaled_init((D, D), generator, device=device,
                                 dtype=param_dtype, fan_in=D),
        "mlm_bias": torch.zeros((D,), **f32),
        "mlm_ln_scale": torch.ones((D,), **f32),
        "mlm_ln_bias": torch.zeros((D,), **f32),
        "mlm_out_bias": torch.zeros((cfg.vocab_size,), **f32),
    }
    return {"params": params, "state": {}}


def params_from_numpy(cfg: BertConfig, tree: dict, *, device,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    del cfg
    return tree_from_numpy(tree, device=device, param_dtype=param_dtype)


def forward(cfg: BertConfig, params: dict, tokens: torch.Tensor,
            type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids [B, S] → f32 MLM logits [B, S, vocab] (tied output
    embedding)."""
    dt = cfg.dtype
    S = tokens.shape[1]
    tok_embed = _w(params["tok_embed"], dt)
    x = tok_embed[tokens.long()] + _w(params["pos_embed"], dt)[None, :S]
    if type_ids is not None:
        x = x + _w(params["type_embed"], dt)[type_ids.long()]
    x = layer_norm(x, params["embed_ln_scale"], params["embed_ln_bias"])
    x = encoder.encode(cfg.encoder_config(), params["layers"], x)
    h = gelu(x @ _w(params["mlm_dense"], dt) + _w(params["mlm_bias"], dt))
    h = layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"])
    logits = h @ tok_embed.T + _w(params["mlm_out_bias"], dt)
    return logits.to(torch.float32)


def apply(cfg: BertConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    """``batch``: tokens [B, S] (mask ids substituted), labels [B, S]
    (-1 where unmasked, ignored), optional type_ids."""
    logits = forward(cfg, variables["params"], batch["tokens"],
                     batch.get("type_ids"))
    loss, acc = cross_entropy_loss(logits, batch["labels"])
    return loss, {"loss": loss, "accuracy": acc}, variables["state"]


def logical_axes(cfg: BertConfig) -> Variables:
    return {
        "params": {
            "tok_embed": ("vocab", "embed"),
            "pos_embed": ("seq", "embed"),
            "type_embed": (None, "embed"),
            "embed_ln_scale": ("embed",),
            "embed_ln_bias": ("embed",),
            "layers": encoder.layers_logical_axes(),
            "mlm_dense": ("embed", "embed"),
            "mlm_bias": ("embed",),
            "mlm_ln_scale": ("embed",),
            "mlm_ln_bias": ("embed",),
            "mlm_out_bias": ("vocab",),
        },
        "state": {},
    }


def model_def(name: str, **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ModelDef(
        name=name,
        init=lambda generator, device: init(cfg, generator, device=device),
        apply=functools.partial(apply, cfg),
        unit="tokens",
        config=cfg,
        logical_axes=functools.partial(logical_axes, cfg),
        layer_stacks=("layers",),
    )
