"""What both model families share: initialisation, operand casts, dropout.

- ``init_weights``: the JAX package's initialisers, drawn from an explicit
  generator (``honk_tpu/models/res.py``, ``honk_tpu/models/cnn.py``).
- ``conv`` / ``dense``: a layer in the compute dtype, as flax's ``nn.Conv`` /
  ``nn.Dense`` with ``dtype``: bf16 operands, a bf16 product, then the
  bias added in bf16 (two roundings), the result left in bf16. Its weight
  and bias gradients are flax's too: the sum of the bf16 products, rounded
  to bf16 once. ``Output``: the models' last Dense, float32 in every dtype.
- The parameter gradients these layers sum over the batch's rows leave the
  layer as float64 sums (``_LowConv``: cuDNN's bf16 weight gradient rounds
  more than once), kept by ``wide_grads``; ``finish_grads`` adds them over
  the ranks of a data-parallel step in float64 and rounds each once, so one
  rank and N ranks round the same sum (``models/res.py``'s BN backward
  sums its cotangents the same way).
- ``avg_pool``: flax's ``nn.avg_pool``; in bf16 its window sum is a chain of
  bf16 adds, then a bf16 division by the window's size.
- ``draw_keep_masks`` / ``apply_dropout``: flax's ``nn.Dropout`` with the
  keep masks drawn from an explicit generator, or given from outside.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..metrics.profiling import annotate
from ..ops import wgrad_kernel
from ..ops.res_kernel import chained_avg_pool
# The plain per-sample partials and their columns, the kernel's CPU path.
from ..ops.wgrad_kernel import columns as _columns, conv_wgrad_plain as _conv_weight_partials  # noqa: F401

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
    and bias gradients are float64 sums, not yet rounded (``_LowConv``)."""
    if dtype == torch.float32:
        return layer(x)
    return _LowConv.apply(x, layer.weight, layer.bias, dtype, (layer.stride, layer.padding, layer.dilation))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype``, flax's way: the product rounded to ``dtype``, then the bias added in
    ``dtype``. Its weight and bias gradients are float64 sums, not yet rounded (``_LowDense``)."""
    if dtype == torch.float32:
        return layer(x)
    return _LowDense.apply(x, layer.weight, layer.bias, dtype)


class Output(nn.Linear):
    """The models' last Dense, float32 in every dtype: ``nn.Linear``'s forward and input gradient bit
    for bit, its weight and bias gradients float64 sums (``_Output``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Output.apply(x, self.weight, self.bias)


def cast_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The parameters ``conv`` / ``dense`` cast to the model's dtype: those of
    every Conv2d and Linear but ``model.output``, the float32 Dense of both
    families."""
    return [p for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear)) and m is not model.output
            for p in m.parameters()]


_SINK = threading.local()


@contextlib.contextmanager
def wide_grads():
    """Yields a dict that the layers run inside fill, parameter -> float64 gradient.

    Each of ``_LowConv``, ``_LowDense`` and ``_Output`` sums its parameters'
    gradients over the rows in float64 and, when its forward ran inside
    ``wide_grads`` (the backward may run on another thread), adds that sum to
    the dict; autograd's ``.grad`` gets its float32 rounding all the same,
    for callers that read ``.grad`` alone. ``finish_grads`` takes the dict.
    """
    outer = getattr(_SINK, "grads", None)
    _SINK.grads = grads = {}
    try:
        yield grads
    finally:
        _SINK.grads = outer


def _sink() -> dict | None:
    return getattr(_SINK, "grads", None)


def _keep(sink: dict | None, param: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g``, a float64 gradient of ``param``, added to ``sink``'s (if any)."""
    if sink is not None:
        sink[param] = sink[param] + g if param in sink else g
    return g


@torch.no_grad()
def finish_grads(model: nn.Module, wide: dict, mesh=None) -> None:
    """The update's gradients from a backward run inside ``wide_grads``: every
    parameter's float64 sum over this rank's rows (``wide``'s, or its float32
    ``.grad`` widened, as autograd's float32 convs give it), added over the
    ranks of ``mesh`` in float64 (``mesh.all_reduce_grads``, one flat
    all-reduce), then rounded once into ``.grad``: to float32, and for a
    parameter ``conv`` / ``dense`` casts to the model's dtype also to that
    dtype, widened back for the float32 update (flax's one rounding of the
    whole batch's sum). The float64 sum reaches bf16 through float32, as
    ``Tensor.to`` takes it and as a float32 accumulator rounded to bf16
    would; it parts from a direct rounding only where the float32 value is a
    bf16 tie. One path on every device and topology: at one rank (or without
    ``mesh``) nothing is communicated."""
    params = [p for p in model.parameters() if p.grad is not None]
    sums = [wide[p] if p in wide else p.grad.double() for p in params]
    if mesh is not None and mesh.size > 1:
        mesh.all_reduce_grads(sums)
    cast = set(cast_parameters(model)) if model.dtype != torch.float32 else set()
    for p, s in zip(params, sums):
        p.grad.copy_(s.float().to(model.dtype) if p in cast else s)


def _conv_weight_grad(gy: torch.Tensor, x16: torch.Tensor, shape: torch.Size, geometry) -> torch.Tensor:
    """A conv's float64 weight gradient from its bf16 operands (``gy`` bf16, or float32 holding bf16
    values, which the cast to bf16 keeps exactly): one float32 partial a sample
    (``ops/wgrad_kernel.py::conv_wgrad``, the Hopper kernel on the card, im2col and a float32 GEMM on
    the CPU), every product exact, whose order of summation is the sample's own at any row count
    (``tests/test_torch_topology_invariance.py``, ``tests/test_torch_wgrad_kernel.py``,
    ``chip_smoke.py`` phase 51 on the card); the partials summed over the rows in float64, exactly
    while their magnitudes span less than 2**(29 - log2(rows)) (2**21 at 256 rows), so a rank's part
    and the ranks' sum add to the same value. Not cuDNN's bf16 weight gradient, which rounds more than
    once on the card (conv0 of res8: 4.94% of the elements more than half a bf16 ulp from the truth),
    nor its float32 one, whose algorithm is chosen by shape and includes inexact transforms (0.6-0.7%
    of a 45-map conv's elements past half an ulp at 16 and 32 rows, and no exact zero for a dead input
    channel). The operands go to the kernel contiguous, as it reads them (autograd can hand a strided
    cotangent: the stride-0 expand of a ``.sum()``, or a channels_last one); ``contiguous`` copies
    nothing where they already are."""
    partials = wgrad_kernel.conv_wgrad(gy.to(torch.bfloat16).contiguous(), x16.contiguous(), shape, geometry)
    return partials.sum(dim=0, dtype=torch.float64).view(shape)


class _LowConv(torch.autograd.Function):
    """``conv`` in a low dtype whose weight and bias gradients are float64 sums.

    Forward and input gradient are autograd's ops on the same operands (a
    bf16 product, the bias added in bf16; the input gradient in bf16, cast
    to the input's dtype). The weight gradient is the correlation of the
    bf16 operands (``_conv_weight_grad``), the bias gradient the float64 sum
    of the output's cotangent. Both leave the layer unrounded
    (``wide_grads``): on a rank of a data-parallel step they are a part of
    the batch's sum, and the step rounds the sum once (``finish_grads``), on
    every topology.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, dtype, geometry):
        x16, w16 = x.to(dtype), weight.to(dtype)
        ctx.save_for_backward(x16, w16)
        ctx.geometry, ctx.shape, ctx.x_dtype = geometry, weight.shape, x.dtype
        ctx.params, ctx.sink = (weight, bias), _sink()
        y = F.conv2d(x16, w16, None, *geometry)
        return y if bias is None else y + bias.to(dtype)[:, None, None]

    @staticmethod
    def backward(ctx, gy):
        x16, w16 = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward(gy, x16, w16, None, *ctx.geometry, False, [0, 0], 1,
                                                     [True, False, False])[0].to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            with annotate("conv_weight_grad"):
                gw = _keep(ctx.sink, ctx.params[0], _conv_weight_grad(gy, x16, ctx.shape, ctx.geometry))
        if ctx.params[1] is not None and ctx.needs_input_grad[2]:
            gb = _keep(ctx.sink, ctx.params[1], gy.sum(dim=(0, 2, 3), dtype=torch.float64))
        return gx, gw, gb, None, None


def _dense_grads(ctx, gy: torch.Tensor, x: torch.Tensor) -> tuple:
    """A Dense layer's weight and bias gradients as float64 sums over the rows of ``gy`` and ``x``
    (each product exact for bf16 operands), kept by ``wide_grads``."""
    weight, bias = ctx.params
    gw = _keep(ctx.sink, weight, gy.double().t().mm(x.double())) if ctx.needs_input_grad[1] else None
    gb = _keep(ctx.sink, bias, gy.sum(dim=0, dtype=torch.float64)) if ctx.needs_input_grad[2] else None
    return gw, gb


class _LowDense(torch.autograd.Function):
    """``dense`` in a low dtype whose weight and bias gradients are float64 sums, unrounded (as
    ``_LowConv``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        x16, w16 = x.to(dtype), weight.to(dtype)
        ctx.save_for_backward(x16, w16)
        ctx.x_dtype, ctx.params, ctx.sink = x.dtype, (weight, bias), _sink()
        return F.linear(x16, w16) + bias.to(dtype)

    @staticmethod
    def backward(ctx, gy):
        x16, w16 = ctx.saved_tensors
        gx = gy.mm(w16).to(ctx.x_dtype) if ctx.needs_input_grad[0] else None
        return gx, *_dense_grads(ctx, gy, x16), None


class _Output(torch.autograd.Function):
    """``Output``: ``F.linear`` in float32, its weight and bias gradients float64 sums (as ``_LowDense``)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.params, ctx.sink = (weight, bias), _sink()
        return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        gx = gy.mm(weight) if ctx.needs_input_grad[0] else None
        return gx, *_dense_grads(ctx, gy, x)


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
