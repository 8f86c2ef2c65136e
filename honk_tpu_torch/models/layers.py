"""What both model families share: initialisation, operand casts, dropout.

- ``init_weights``: the JAX package's initialisers, drawn from an explicit
  generator (``honk_tpu/models/res.py``, ``honk_tpu/models/cnn.py``).
- ``conv`` / ``dense``: a layer with its operands in the compute dtype
  (flax's ``dtype``: bf16 operands, the result returned in float32).
- ``draw_keep_masks`` / ``apply_dropout``: flax's ``nn.Dropout`` with the
  keep masks drawn from an explicit generator, or given from outside.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# Standard deviation of a standard normal truncated to [-2, 2]: flax's
# truncated_normal(stddev) scales its [-2, 2] samples by stddev / this.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation of ``model``, drawn from ``generator``.

    Conv and Dense kernels: uniform in +-1/sqrt(fan_in) (flax's
    ``variance_scaling(1/3, "fan_in", "uniform")``, also torch's default for
    these layers), or, for a CNN with ``tf_variant`` (cnn-trad-pool2,
    cnn-one-stride1), flax's ``truncated_normal(0.01)``: a standard normal
    truncated to +-2, scaled by ``0.01 / 0.8796...``, so within +-0.02274
    with a standard deviation of 0.01. Biases 0; BN running mean 0,
    variance 1.
    """
    truncated = getattr(model, "tf_variant", False)
    for name, p in model.named_parameters():
        if not name.endswith("weight"):
            p.zero_()
        elif truncated:
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.mul_(0.01 / _TRUNC_STD)
        else:
            bound = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.rand(p.shape, generator=generator, device=generator.device) * (2 * bound) - bound)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return model


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with its operands in ``dtype``; float32 out."""
    if dtype == torch.float32:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride, layer.padding,
                    layer.dilation).float()


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with its operands in ``dtype``; float32 out."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype)).float()


def draw_keep_masks(generator: torch.Generator, shapes: Sequence[tuple[int, ...]],
                    keep_prob: float) -> list[torch.Tensor]:
    """One bool keep mask per shape, in order, each element kept with ``keep_prob``,
    on the generator's device."""
    return [torch.rand(s, generator=generator, device=generator.device) < keep_prob for s in shapes]


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """flax's arithmetic: ``where(keep, x / keep_prob, 0)`` (a division, not a product)."""
    if keep.shape != x.shape or keep.dtype != torch.bool:
        raise ValueError(f"a keep mask is a bool tensor of the layer's shape {tuple(x.shape)}, "
                         f"got {keep.dtype} {tuple(keep.shape)}")
    return torch.where(keep, x / keep_prob, 0.0)
