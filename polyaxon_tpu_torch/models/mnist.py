"""MNIST CNN, the quick-start model (port of
``polyaxon_tpu/models/mnist.py``): two 3x3 convolutions with 2x2 max
pools and two dense layers. Kernels keep the JAX HWIO layout and images
arrive NHWC (``models/resnet.py``'s ``conv_same`` permutes at the call);
the flatten before ``dense1`` reads NHWC order, as the reference's
does."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    cross_entropy_loss,
    scaled_init,
    tree_from_numpy,
)
from polyaxon_tpu_torch.models.resnet import conv_same


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    num_classes: int = 10
    dtype: Any = torch.bfloat16


CONFIGS = {"mnist_cnn": MnistConfig()}


def init(cfg: MnistConfig, generator: torch.Generator, *,
         device) -> Variables:
    def w(shape, fan_in):
        return scaled_init(shape, generator, device=device, fan_in=fan_in)

    def zeros(n):
        return torch.zeros(n, device=device)

    params = {
        "conv1": w((3, 3, 1, 32), 9), "conv1_b": zeros(32),
        "conv2": w((3, 3, 32, 64), 288), "conv2_b": zeros(64),
        "dense1": w((7 * 7 * 64, 256), 7 * 7 * 64), "dense1_b": zeros(256),
        "dense2": w((256, cfg.num_classes), 256),
        "dense2_b": zeros(cfg.num_classes),
    }
    return {"params": params, "state": {}}


def params_from_numpy(cfg: MnistConfig, tree: dict, *, device) -> dict:
    del cfg
    return tree_from_numpy(tree, device=device, param_dtype=torch.float32)


def forward(cfg: MnistConfig, params: dict, images: torch.Tensor
            ) -> torch.Tensor:
    """NHWC (or NHW) images → f32 logits [B, num_classes]."""
    dt = cfg.dtype
    x = images.to(dt)
    if x.ndim == 3:
        x = x[..., None]
    x = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        x = conv_same(x, params[name].to(dt)) + params[f"{name}_b"].to(
            dt)[None, :, None, None]
        x = F.max_pool2d(F.relu(x), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["dense1"].to(dt) + params["dense1_b"].to(dt))
    return (x @ params["dense2"].to(dt)
            + params["dense2_b"].to(dt)).to(torch.float32)


def apply(cfg: MnistConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    logits = forward(cfg, variables["params"], batch["image"])
    loss, acc = cross_entropy_loss(logits, batch["label"])
    return loss, {"loss": loss, "accuracy": acc}, variables["state"]


def logical_axes(cfg: MnistConfig) -> Variables:
    return {
        "params": {
            "conv1": (None, None, "conv_in", "conv_out"),
            "conv1_b": ("conv_out",),
            "conv2": (None, None, "conv_in", "conv_out"),
            "conv2_b": ("conv_out",),
            "dense1": (None, "mlp"),
            "dense1_b": ("mlp",),
            "dense2": ("mlp", "classes"),
            "dense2_b": ("classes",),
        },
        "state": {},
    }


def model_def(name: str = "mnist_cnn", **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ModelDef(
        name=name,
        init=lambda generator, device: init(cfg, generator, device=device),
        apply=functools.partial(apply, cfg),
        unit="examples",
        config=cfg,
        logical_axes=functools.partial(logical_axes, cfg),
    )
