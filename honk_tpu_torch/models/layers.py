"""What both model families share: initialisation, operand casts, dropout.

- ``init_weights``: the JAX package's initialisers, drawn from an explicit
  generator (``honk_tpu/models/res.py``, ``honk_tpu/models/cnn.py``).
- ``conv`` / ``dense``: a layer in the compute dtype, as flax's ``nn.Conv`` /
  ``nn.Dense`` with ``dtype``: bf16 operands, a bf16 product, then the
  bias added in bf16 (two roundings), the result left in bf16.
- ``avg_pool``: flax's ``nn.avg_pool``; in bf16 its window sum is a chain of
  bf16 adds, then a bf16 division by the window's size.
- ``draw_keep_masks`` / ``apply_dropout``: flax's ``nn.Dropout`` with the
  keep masks drawn from an explicit generator, or given from outside.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.res_kernel import chained_avg_pool

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
    """``layer(x)`` in ``dtype``, flax's way: the product rounded to ``dtype``,
    then the bias added in ``dtype`` (not fused into the product)."""
    if dtype == torch.float32:
        return layer(x)
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding, layer.dilation)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None, None]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype``, flax's way: the product rounded to ``dtype``, then the bias added in ``dtype``."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def avg_pool(x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """flax's ``nn.avg_pool(window, strides=window, padding="VALID")`` of NCHW ``x``, in ``x``'s dtype.

    float32: ``F.avg_pool2d``. In bf16, flax's ``reduce_window`` adds the
    window's values one by one in bf16 in row-major window order, and the sum
    is divided by the window's size in bf16; ``F.avg_pool2d`` would sum in
    float and round once. The backward is JAX's transpose: the cotangent
    divided by the window's size in bf16, broadcast over the window.
    """
    if x.dtype == torch.float32:
        return F.avg_pool2d(x, window)
    return _ChainedAvgPool.apply(x, tuple(window))


def _windows(x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> the (B, C, H // ph, ph, W // pw, pw) view of the rows and columns the pool reads."""
    (ph, pw), (b, c, h, w) = window, x.shape
    return x[:, :, : h // ph * ph, : w // pw * pw].view(b, c, h // ph, ph, w // pw, pw)


class _ChainedAvgPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
        ctx.shape, ctx.window = x.shape, window
        return chained_avg_pool(x, window)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        ph, pw = ctx.window
        g = g / (ph * pw)
        gx = g.new_zeros(ctx.shape)
        _windows(gx, ctx.window).copy_(g[:, :, :, None, :, None].expand(-1, -1, -1, ph, -1, pw))
        return gx, None


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
