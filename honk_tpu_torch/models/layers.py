"""What both model families share: initialisation, operand casts, dropout.

- ``init_weights``: the JAX package's initialisers, drawn from an explicit
  generator (``honk_tpu/models/res.py``, ``honk_tpu/models/cnn.py``).
- ``conv`` / ``dense``: a layer in the compute dtype, as flax's ``nn.Conv`` /
  ``nn.Dense`` with ``dtype``: bf16 operands, a bf16 product, then the
  bias added in bf16 (two roundings), the result left in bf16. Its weight
  and bias gradients are flax's too: the float32 sum of the bf16 products,
  rounded to bf16 once. The layer sums them in float32 itself
  (``_LowConv``: cuDNN's bf16 weight gradient rounds more than once) and
  leaves them unrounded; the train step rounds them once, after the
  all-reduce of a data-parallel step (``round_cast_grads``), so one rank
  and N ranks round the same sum.
- ``avg_pool``: flax's ``nn.avg_pool``; in bf16 its window sum is a chain of
  bf16 adds, then a bf16 division by the window's size.
- ``draw_keep_masks`` / ``apply_dropout``: flax's ``nn.Dropout`` with the
  keep masks drawn from an explicit generator, or given from outside.
"""

from __future__ import annotations

import contextlib
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
    then the bias added in ``dtype`` (not fused into the product). Its weight
    and bias gradients are float32 sums, not yet rounded (``_LowConv``)."""
    if dtype == torch.float32:
        return layer(x)
    return _LowConv.apply(x, layer.weight, layer.bias, dtype, (layer.stride, layer.padding, layer.dilation))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype``, flax's way: the product rounded to ``dtype``, then the bias added in
    ``dtype``. Its weight and bias gradients are float32 sums, not yet rounded (``_LowDense``)."""
    if dtype == torch.float32:
        return layer(x)
    return _LowDense.apply(x, layer.weight, layer.bias, dtype)


def cast_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The parameters ``conv`` / ``dense`` cast to the model's dtype: those of
    every Conv2d and Linear but ``model.output``, the float32 Dense of both
    families."""
    return [p for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear)) and m is not model.output
            for p in m.parameters()]


@torch.no_grad()
def round_cast_grads(model: nn.Module) -> None:
    """After the backward of a step in a low dtype (and the all-reduce of a
    sharded one): round the float32 sum that is the gradient of every
    parameter ``conv`` / ``dense`` cast to the model's dtype to that dtype,
    once, and widen it back for the float32 update: flax's one rounding of
    the whole batch's sum."""
    if model.dtype == torch.float32:
        return
    for p in cast_parameters(model):
        if p.grad is not None:
            p.grad.copy_(p.grad.to(model.dtype))


@contextlib.contextmanager
def _full_f32():
    """cuBLAS's float32 products outside TF32 inside, whatever the process
    set, restored after."""
    flag, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _columns(x: torch.Tensor, shape: torch.Size, out_hw: tuple[int, int], geometry) -> torch.Tensor:
    """im2col of (B, C, H, W) ``x`` for a conv of weight ``shape`` and output size ``out_hw``:
    (B, C * kh * kw, Ho * Wo), ``F.unfold``'s layout, as one strided copy of the padded input
    (``F.unfold`` on the card launches a kernel for each row)."""
    stride, padding, dilation = geometry
    xp = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
    b, c, (kh, kw), (ho, wo) = x.shape[0], x.shape[1], shape[2:], out_hw
    sb, sc, sh, sw = xp.stride()
    view = xp.as_strided((b, c, kh, kw, ho, wo), (sb, sc, dilation[0] * sh, dilation[1] * sw,
                                                  stride[0] * sh, stride[1] * sw))
    return view.reshape(b, c * kh * kw, ho * wo)


def _conv_weight_grad(gy32: torch.Tensor, x16: torch.Tensor, shape: torch.Size, geometry) -> torch.Tensor:
    """A conv's float32 weight gradient from its bf16 operands: im2col, then a
    batched float32 GEMM (every product exact, TF32 off) summed over the
    rows. Not cuDNN's bf16 weight gradient, which rounds more than once on
    the card (conv0 of res8: 4.94% of the elements more than half a bf16 ulp
    from the truth), nor its float32 one, whose algorithm is chosen by shape
    and includes inexact transforms (0.6-0.7% of a 45-map conv's elements
    past half an ulp at 16 and 32 rows, and no exact zero for a dead input
    channel; PERF.md §6)."""
    cols = _columns(x16, shape, gy32.shape[2:], geometry).float()
    with _full_f32():
        return torch.bmm(gy32.flatten(2), cols.transpose(1, 2)).sum(dim=0).view(shape)


class _LowConv(torch.autograd.Function):
    """``conv`` in a low dtype whose weight and bias gradients are summed in float32.

    Forward and input gradient are autograd's ops on the same operands (a
    bf16 product, the bias added in bf16; the input gradient in bf16, cast
    to the input's dtype). The weight gradient is the float32 correlation of
    the bf16 operands (``_conv_weight_grad``: every product exact, summed in
    float32), the bias gradient the float32 sum of the output's cotangent.
    Both leave the layer unrounded: on a rank of a data-parallel step they
    are a part of the batch's sum, and the step rounds the sum once
    (``round_cast_grads``), on every topology.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, dtype, geometry):
        x16, w16 = x.to(dtype), weight.to(dtype)
        ctx.save_for_backward(x16, w16)
        ctx.geometry, ctx.shape, ctx.x_dtype, ctx.has_bias = geometry, weight.shape, x.dtype, bias is not None
        y = F.conv2d(x16, w16, None, *geometry)
        return y if bias is None else y + bias.to(dtype)[:, None, None]

    @staticmethod
    def backward(ctx, gy):
        x16, w16 = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward(gy, x16, w16, None, *ctx.geometry, False, [0, 0], 1,
                                                     [True, False, False])[0].to(ctx.x_dtype)
        gy32 = gy.float()
        if ctx.needs_input_grad[1]:
            gw = _conv_weight_grad(gy32, x16, ctx.shape, ctx.geometry)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy32.sum(dim=(0, 2, 3))
        return gx, gw, gb, None, None


class _LowDense(torch.autograd.Function):
    """``dense`` in a low dtype whose weight and bias gradients are summed in float32, unrounded (as
    ``_LowConv``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        x16, w16 = x.to(dtype), weight.to(dtype)
        ctx.save_for_backward(x16, w16)
        ctx.x_dtype = x.dtype
        return F.linear(x16, w16) + bias.to(dtype)

    @staticmethod
    def backward(ctx, gy):
        x16, w16 = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = gy.mm(w16).to(ctx.x_dtype)
        gy32 = gy.float()
        if ctx.needs_input_grad[1]:
            with _full_f32():
                gw = gy32.t().mm(x16.float())
        if ctx.needs_input_grad[2]:
            gb = gy32.sum(dim=0)
        return gx, gw, gb, None


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
