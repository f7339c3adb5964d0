"""Vision Transformer (port of ``polyaxon_tpu/models/vit.py``): patches
of NHWC images, a class token and learned positions through
``models/encoder.py``'s stack at its default ``attention_impl="xla"``
(the reference's config does not forward the field, so ViT reaches no
flash kernel in either package), then a linear head on the class token.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from polyaxon_tpu_torch.models import encoder
from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _w,
    cross_entropy_loss,
    layer_norm,
    scaled_init,
    tree_from_numpy,
    truncated_normal_init,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    dtype: Any = torch.bfloat16
    remat: str = "none"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def encoder_config(self) -> encoder.EncoderConfig:
        return encoder.EncoderConfig(
            dim=self.dim, n_layers=self.n_layers, n_heads=self.n_heads,
            ffn_dim=self.ffn_dim, dtype=self.dtype, remat=self.remat,
        )


CONFIGS: dict[str, ViTConfig] = {
    "vit_b16": ViTConfig(),
    "vit_s16": ViTConfig(dim=384, n_layers=12, n_heads=6, ffn_dim=1536),
    "vit_tiny": ViTConfig(image_size=32, patch_size=8, num_classes=10,
                          dim=64, n_layers=2, n_heads=4, ffn_dim=128),
}


def init(cfg: ViTConfig, generator: torch.Generator, *, device,
         param_dtype: torch.dtype = torch.float32) -> dict:
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    f32 = dict(dtype=torch.float32, device=device)
    params = {
        "patch_embed": scaled_init((patch_dim, cfg.dim), generator,
                                   device=device, dtype=param_dtype,
                                   fan_in=patch_dim),
        "patch_bias": torch.zeros((cfg.dim,), **f32),
        "cls_token": truncated_normal_init((1, 1, cfg.dim), generator,
                                           device=device, dtype=param_dtype),
        "pos_embed": truncated_normal_init((1, cfg.n_patches + 1, cfg.dim),
                                           generator, device=device,
                                           dtype=param_dtype),
        "layers": encoder.init_layers(cfg.encoder_config(), generator,
                                      device=device, param_dtype=param_dtype),
        "final_ln_scale": torch.ones((cfg.dim,), **f32),
        "final_ln_bias": torch.zeros((cfg.dim,), **f32),
        # Zero-init classifier head: the initial loss is ln(num_classes).
        "head": torch.zeros((cfg.dim, cfg.num_classes), dtype=param_dtype,
                            device=device),
        "head_bias": torch.zeros((cfg.num_classes,), **f32),
    }
    return {"params": params, "state": {}}


def params_from_numpy(cfg: ViTConfig, tree: dict, *, device,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    del cfg
    return tree_from_numpy(tree, device=device, param_dtype=param_dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] → [B, (H/p)*(W/p), p*p*C]."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // patch) * (W // patch), patch * patch * C)


def forward(cfg: ViTConfig, params: dict, images: torch.Tensor
            ) -> torch.Tensor:
    """NHWC images → f32 class logits [B, num_classes]."""
    dt = cfg.dtype
    x = patchify(images.to(dt), cfg.patch_size)
    x = x @ _w(params["patch_embed"], dt) + _w(params["patch_bias"], dt)
    B = x.shape[0]
    cls = _w(params["cls_token"], dt).expand(B, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + _w(params["pos_embed"], dt)
    x = encoder.encode(cfg.encoder_config(), params["layers"], x)
    x = layer_norm(x[:, 0], params["final_ln_scale"], params["final_ln_bias"])
    return (x @ _w(params["head"], dt)
            + _w(params["head_bias"], dt)).to(torch.float32)


def apply(cfg: ViTConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    logits = forward(cfg, variables["params"], batch["image"])
    loss, acc = cross_entropy_loss(logits, batch["label"])
    return loss, {"loss": loss, "accuracy": acc}, variables["state"]


def logical_axes(cfg: ViTConfig) -> Variables:
    return {
        "params": {
            "patch_embed": (None, "embed"),
            "patch_bias": ("embed",),
            "cls_token": (None, None, "embed"),
            "pos_embed": (None, "seq", "embed"),
            "layers": encoder.layers_logical_axes(),
            "final_ln_scale": ("embed",),
            "final_ln_bias": ("embed",),
            "head": ("embed", "classes"),
            "head_bias": ("classes",),
        },
        "state": {},
    }


def model_def(name: str, **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ModelDef(
        name=name,
        init=lambda generator, device: init(cfg, generator, device=device),
        apply=functools.partial(apply, cfg),
        unit="examples",
        config=cfg,
        logical_axes=functools.partial(logical_axes, cfg),
        layer_stacks=("layers",),
    )
