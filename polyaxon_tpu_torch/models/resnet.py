"""ResNet-50 with BatchNorm running statistics (port of
``polyaxon_tpu/models/resnet.py``).

Parameters keep the JAX layouts, so weights move as an identity map:
convolution kernels are HWIO ``[kh, kw, in, out]`` and images arrive
NHWC. Inside, activations run NCHW and each kernel is permuted to OIHW
where ``conv2d`` is called; XLA's ``"SAME"`` padding (``pad_lo = total //
2``, the extra row and column at the end) is applied explicitly. The
convolutions are cuDNN on the card, as the reference's are XLA's: no
Pallas kernel.

BatchNorm is the one stateful layer: running mean and variance live in
``variables["state"]``, and a training ``apply`` returns them updated
(momentum 0.9, eps 1e-5) from the batch statistics, which the train step
threads through its microbatches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
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
from polyaxon_tpu_torch.parallel.mesh import block_mean

BN_MOMENTUM = 0.9
BN_EPS = 1e-5

# (blocks per stage, channels) for ResNet-50.
STAGES = ((3, 256), (4, 512), (6, 1024), (3, 2048))


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    width: int = 64
    stages: tuple = STAGES
    dtype: Any = torch.bfloat16


CONFIGS = {
    "resnet50": ResNetConfig(),
    "resnet_tiny": ResNetConfig(num_classes=10, width=8,
                                stages=((1, 32), (1, 64))),
}


def init(cfg: ResNetConfig, generator: torch.Generator, *,
         device) -> Variables:
    def conv(kh, kw, cin, cout):
        return scaled_init((kh, kw, cin, cout), generator, device=device,
                           fan_in=kh * kw * cin)

    def bn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    def bn_state(c):
        return {"mean": torch.zeros(c, device=device),
                "var": torch.ones(c, device=device)}

    params: dict = {"stem_conv": conv(7, 7, 3, cfg.width),
                    "stem_bn": bn(cfg.width)}
    state: dict = {"stem_bn": bn_state(cfg.width)}
    cin = cfg.width
    for si, (n_blocks, cout) in enumerate(cfg.stages):
        mid = cout // 4
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            block = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                     "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                     "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
            bstate = {"bn1": bn_state(mid), "bn2": bn_state(mid),
                      "bn3": bn_state(cout)}
            if bi == 0 and cin != cout:
                block["proj"] = conv(1, 1, cin, cout)
                block["proj_bn"] = bn(cout)
                bstate["proj_bn"] = bn_state(cout)
            params[name] = block
            state[name] = bstate
            cin = cout
    params["head"] = scaled_init((cin, cfg.num_classes), generator,
                                 device=device, fan_in=cin)
    params["head_bias"] = torch.zeros(cfg.num_classes, device=device)
    return {"params": params, "state": state}


def params_from_numpy(cfg: ResNetConfig, tree: dict, *, device) -> dict:
    """A JAX params or state tree as numpy arrays → f32 port tensors
    (identity map)."""
    del cfg
    return tree_from_numpy(tree, device=device, param_dtype=torch.float32)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """NCHW activations × an HWIO kernel, "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (*pw, *ph))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``reduce_window(max)`` with "SAME" padding (pads hold -inf)."""
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (*pw, *ph), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def _bn(x: torch.Tensor, p: dict, s: dict, train: bool):
    """(normalized, new running state); statistics over N, H, W in f32,
    of the global batch under a mesh whose batch axes hold different
    rows (``block_mean`` over the row blocks, two passes as ``jnp.var``
    takes them), so every rank keeps the same running statistics."""
    x32 = x.to(torch.float32)
    if train:
        mean = block_mean(x32.mean(dim=(0, 2, 3)))
        c = (None, slice(None), None, None)
        var = block_mean((x32 - mean[c]).square().mean(dim=(0, 2, 3)))
        new_state = {
            "mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var,
        }
    else:
        mean, var = s["mean"], s["var"]
        new_state = s
    c = (None, slice(None), None, None)
    y = ((x32 - mean[c]) * torch.rsqrt(var[c] + BN_EPS) * p["scale"][c]
         + p["bias"][c])
    return y.to(x.dtype), new_state


def _block(x, p, s, stride: int, train: bool):
    dt = x.dtype
    new_s = {}
    h, new_s["bn1"] = _bn(conv_same(x, p["conv1"].to(dt)), p["bn1"],
                          s["bn1"], train)
    h = F.relu(h)
    h, new_s["bn2"] = _bn(conv_same(h, p["conv2"].to(dt), stride), p["bn2"],
                          s["bn2"], train)
    h = F.relu(h)
    h, new_s["bn3"] = _bn(conv_same(h, p["conv3"].to(dt)), p["bn3"],
                          s["bn3"], train)
    if "proj" in p:
        x, new_s["proj_bn"] = _bn(conv_same(x, p["proj"].to(dt), stride),
                                  p["proj_bn"], s["proj_bn"], train)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return F.relu(x + h), new_s


def forward(cfg: ResNetConfig, params: dict, state: dict,
            images: torch.Tensor, train: bool):
    """NHWC images → (f32 logits [B, num_classes], new state)."""
    dt = cfg.dtype
    x = images.to(dt).permute(0, 3, 1, 2)
    new_state: dict = {}
    x = conv_same(x, params["stem_conv"].to(dt), stride=2)
    x, new_state["stem_bn"] = _bn(x, params["stem_bn"], state["stem_bn"],
                                  train)
    x = max_pool_same(F.relu(x), 3, 2)
    for si, (n_blocks, _) in enumerate(cfg.stages):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            x, new_state[name] = _block(x, params[name], state[name], stride,
                                        train)
    x = x.mean(dim=(2, 3)).to(torch.float32)
    logits = x @ params["head"].to(torch.float32) + params["head_bias"]
    return logits, new_state


def apply(cfg: ResNetConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    logits, new_state = forward(cfg, variables["params"], variables["state"],
                                batch["image"], train)
    loss, acc = cross_entropy_loss(logits, batch["label"])
    return loss, {"loss": loss, "accuracy": acc}, new_state


def logical_axes(cfg: ResNetConfig) -> Variables:
    """The JAX package's rule over the init tree's leaves (drawn on the
    meta device: shapes only)."""
    variables = init(cfg, torch.Generator(), device="meta")

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (k,)) for k, v in tree.items()}
        if "head" in names and "head_bias" not in names:
            return ("embed", "classes")
        if names[-1] == "head_bias":
            return ("classes",)
        if tree.ndim == 4:
            return (None, None, "conv_in", "conv_out")
        return ("conv_out",) if tree.ndim == 1 else (None,) * tree.ndim

    return walk(variables, ())


def model_def(name: str = "resnet50", **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ModelDef(
        name=name,
        init=lambda generator, device: init(cfg, generator, device=device),
        apply=functools.partial(apply, cfg),
        unit="examples",
        config=cfg,
        logical_axes=functools.partial(logical_axes, cfg),
    )
