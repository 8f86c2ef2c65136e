"""Tang & Lin residual KWS family as an ``nn.Module`` (counterpart of ``honk_tpu.models.res``).

Architecture per layer i in 0..n_layers (reference ``utils/model.py::SpeechResModel``):

    y = relu(conv_i(x))            # 3x3, bias-free; res15: dilation d = 2**((i-1)//3), padding d
    i == 0: optional avg-pool (res8: 4x3, res26: 2x2); old_x = y
    i  > 0 and i even: x = y + old_x; old_x = x      (identity residual)
    else:              x = y
    i  > 0: x = batchnorm_i(x)     # affine-free, AFTER the add

then the global mean over (time, freq) and a Dense(n_maps -> n_labels).
res15's dilation follows the JAX package's code (``honk_tpu/models/res.py:63``,
``(i - 1) // 3``: layers 1-3 take 1, ..., 10-12 take 8, 13 takes 16), not
its comments (``2^(i//3)``).

Parameter names are honk's state-dict names (``conv{i}.weight``,
``bn{i}.running_mean`` / ``running_var``, ``output.weight`` / ``bias``), so
a honk ``.pt`` loads with no converter (``torch_compat``).

The eval forward (``model.eval()``) computes what flax's
``model.apply(train=False)`` of a model built with that ``dtype``
computes: a float32 model (every service, ``--type eval``) is float32
throughout; a bf16 one (a training run's dev and test sweeps at the
default ``--compute_dtype bfloat16``, ``make_forward`` of a bf16 model)
follows flax's dtype flow, as in training (below), with BN from the
running statistics rounded back to bf16. For res8 and res26 it is one
launch of the res-stack kernel from the features (``res_forward``): conv0,
ReLU and the pool (``stem``'s flow, bf16 in a bf16 model) and the stack,
float32 in a float32 model, its ``bfloat16_activations`` mode in a bf16
one (bf16 operands, each layer's output, the residual sum and BN's output
rounded to bf16, the mean in float32 and a float32 Dense). The kernel's
``bfloat16`` mode, the TPU
kernel's float32 activations with a bf16 Dense, is not on this path. The
kernel takes no dilated convs (nor does the TPU's), so res15 runs every
conv through cuDNN in ``dtype`` with flax's dtype flow, with BN folded as
the kernel's operands fold it (``fold_bn``) and, in bf16, rounded back to
bf16 as flax's eval BN returns it; ``use_full_f32`` keeps the float32
convs out of TF32.
``frozen_forward`` is the float32 eval forward of every config as PyTorch
ops under autograd, with that fold:
personalization differentiates it (``serve.TrainingService``), as the JAX
package fine-tunes its float32 service model.

The training forward (``model.train()``) is plain PyTorch with autograd:
the convolutions go through cuDNN (the JAX package has no Pallas kernel for
them either), in ``dtype`` or float32. In bf16 it computes what flax's
``apply(train=True)`` of a bf16 model computes: every conv returns bf16,
ReLU, the pool (``layers.avg_pool``: bf16 adds in window order) and the
residual add stay bf16, BN takes its statistics over the float32 values,
normalises in float32 and returns bf16, and the global mean is taken over
the float32 values. BN's sums over the rows, forward and backward, are
float64 (``batch_moments``, ``_BatchNorm``), as are the layers' parameter
gradients (``layers``), so every topology of a data-parallel step takes
the same step. BN uses batch statistics with flax's semantics
(``honk_tpu/models/res.py``): the biased batch variance as
``E[x^2] - E[x]^2`` clipped at 0, eps 1e-5, in float32, and running
statistics updated by hand, ``r = 0.9 * r + 0.1 * batch`` with the
*biased* variance (``nn.BatchNorm2d`` would use the unbiased one). Params,
the running statistics, the Dense and the loss stay float32.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..metrics.profiling import annotate
from ..ops.res_kernel import BN_EPS, fold_bn, pack_res_params, res_forward, stem_plain
from ..parallel.mesh import DataMesh
from .layers import Output, avg_pool, conv

BN_MOMENTUM = 0.9  # flax's convention: r = momentum * r + (1 - momentum) * batch


class SpeechResModel(nn.Module):
    """Residual keyword spotter. Input: (B, 101, 40) MFCC -> (B, n_labels) logits.

    ``dtype`` is the compute dtype of the convolutions and the activations
    (flax's ``dtype``), in training and in eval: ``torch.bfloat16`` or None /
    ``torch.float32``.
    """

    def __init__(self, config: dict[str, Any], dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.n_maps = config["n_feature_maps"]
        self.n_layers = config["n_layers"]
        self.pool = tuple(config["res_pool"]) if "res_pool" in config else None
        self.dilated = bool(config.get("use_dilation", False))
        self.conv0 = nn.Conv2d(1, self.n_maps, 3, padding=1, bias=False)
        for i in range(1, self.n_layers + 1):
            d = 2 ** ((i - 1) // 3) if self.dilated else 1
            self.add_module(f"conv{i}", nn.Conv2d(self.n_maps, self.n_maps, 3, padding=d, dilation=d, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(self.n_maps, affine=False))
        self.output = Output(self.n_maps, config["n_labels"])

    def eval_operands(self) -> tuple[torch.Tensor, ...]:
        """What the eval forward takes from the weights, to prepare once per set
        of weights: the res-stack kernel's operands for the model's ``dtype``
        (``pack_res_params``: its ``bfloat16_activations`` mode for a bf16
        model), or for a dilated config the BN fold (``fold_bn``)."""
        return fold_bn(self) if self.dilated else pack_res_params(self, self.dtype, self.dtype)

    def stem(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """conv0 -> ReLU -> pool in ``dtype``'s flow (flax's: in bf16 each returns
        bf16, the pool ``layers.avg_pool``'s chain): (B, 101, 40) -> (B, C, H, W)
        float32, the TPU kernel's input (holding bf16 values for a bf16
        ``dtype``), as PyTorch ops (``res_kernel.stem_plain``). The eval
        forward runs it inside the kernel."""
        return stem_plain(x, self.conv0.weight, self.pool, dtype)

    def forward(self, x: torch.Tensor, packed: tuple[torch.Tensor, ...] | None = None,
                dropout: Any = None, mesh: DataMesh | None = None) -> torch.Tensor:
        """Logits. Eval mode: ``packed`` is ``eval_operands()``, computed here if None.

        Training mode also updates the BN running statistics in place; under
        a ``mesh`` of more than one rank, ``x`` is this rank's rows of the
        batch and BN's statistics are the global batch's. The res family has
        no dropout: ``dropout`` (a CNN's keep masks or their generator) is
        accepted and unused, so every model trains through one call.
        """
        if self.training:
            return self._stack(x, self.dtype, lambda i, y: batch_norm_train(y, getattr(self, f"bn{i}"), mesh))
        if packed is None:
            packed = self.eval_operands()
        with annotate("eval_forward"):
            if not self.dilated:
                return res_forward(x.contiguous(), self.conv0.weight, self.pool, *packed, compute_dtype=self.dtype,
                                   activation_dtype=self.dtype)
            return self._folded_stack(x, self.dtype, *packed)

    def frozen_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 eval forward's logits as PyTorch ops under autograd, in
        either mode: BN from the running statistics, folded as ``fold_bn``
        folds them (buffers only, so gradients reach the conv and Dense weights
        as through flax's ``train=False``). This is what a fine-tune
        differentiates: the res-stack kernel, like the TPU's, has no backward."""
        return self._folded_stack(x, torch.float32, *fold_bn(self))

    def _folded_stack(self, x: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor,
                      offset: torch.Tensor) -> torch.Tensor:
        scale, offset = scale[:, :, None, None], offset[:, :, None, None]
        return self._stack(x, dtype, lambda i, y: (y * scale[i - 1] + offset[i - 1]).to(y.dtype))

    def _stack(self, x: torch.Tensor, dtype: torch.dtype,
               norm: Callable[[int, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The whole model as PyTorch ops in ``dtype``'s flow, BN of layer i as ``norm(i, x)``."""
        y = F.relu(conv(self.conv0, x[:, None], dtype))
        x = old = y if self.pool is None else avg_pool(y, self.pool)
        for i in range(1, self.n_layers + 1):
            y = F.relu(conv(getattr(self, f"conv{i}"), x, dtype))
            if i % 2 == 0:
                x = old = y + old
            else:
                x = y
            x = norm(i, x)
        return self.output(x.float().mean(dim=(2, 3)))


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, mesh: DataMesh | None = None) -> torch.Tensor:
    """Affine-free BN of (B, C, H, W) with batch statistics, flax semantics; updates ``bn``'s buffers.

    Under a ``mesh`` of more than one rank, ``x`` is this rank's rows: the
    statistics are the global batch's and every rank updates the same
    running statistics, as GSPMD's BN does (``_BatchNorm``).

    A bf16 ``x`` is normalised as flax normalises it: statistics over its
    float32 values, ``x - mean`` in float32, the result rounded to bf16.
    """
    with annotate("bn_forward"):
        out, mean, var = _BatchNorm.apply(x, mesh if mesh is not None and mesh.size > 1 else None)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    return out


def batch_moments(xf: torch.Tensor, mesh: DataMesh | None = None) -> tuple[torch.Tensor, ...]:
    """BN's per-channel batch mean and mean of squares of (B, C, H, W) ``xf``,
    in its dtype, and the batch's count (a float64 scalar); under a ``mesh``
    of more than one rank the global batch's, the sums and the count
    all-reduced.

    The sums of ``xf`` and ``xf * xf`` are float64 (of bf16 values: exact,
    their squares exact in float32), divided by the count in float64 and
    rounded to ``xf``'s dtype once, so one rank and N ranks, whose float32
    sums would group the rows otherwise, normalise by the same statistics:
    the float32 sums of 2 or 4 parts of res8's batch differ from the whole
    batch's in 8-36 of its 45 channels, on the card and on the CPU
    (``scripts/chip_train_nccl.py --sections bf16parts``, PERF.md §6)."""
    c = xf.shape[1]
    count = xf.new_full((1,), xf.numel() // c, dtype=torch.float64)
    stats = torch.cat([xf.sum(dim=(0, 2, 3), dtype=torch.float64), (xf * xf).sum(dim=(0, 2, 3), dtype=torch.float64),
                       count])
    if mesh is not None and mesh.size > 1:
        mesh.all_reduce_(stats)
    return (stats[:c] / stats[-1]).to(xf.dtype), (stats[c:2 * c] / stats[-1]).to(xf.dtype), stats[-1]


class _BatchNorm(torch.autograd.Function):
    """``(out, mean, var)`` of affine-free BN with batch statistics (``batch_norm_train``); ``mean``
    and ``var`` are not differentiated.

    Forward, with ``w`` the wider of ``x``'s dtype and float32: ``mean`` and
    ``meansq`` from ``batch_moments`` of ``x`` in ``w`` (one all-reduce under
    a ``mesh``), ``var = max(meansq - mean**2, 0)``,
    ``out = ((x - mean) * rsqrt(var + eps))`` rounded to ``x``'s dtype.

    Backward, flax's VJP of that forward with its two cross-row sums taken
    over the global batch in float64: this rank's per-channel sums of the
    cotangent ``g`` and of ``g * (x - mean)`` (the products in ``w``),
    all-reduced in float64 as one pair, give the cotangents of ``mean`` and
    ``var`` in float64, and from them, by one formula on every topology, the
    input gradient elementwise in ``w``. flax's dtype flow is kept: ``x``
    enters twice, through the statistics' cast and through ``x - mean``'s
    promotion, so the two cotangents are rounded to ``x``'s dtype apart and
    added in it (in bf16 for a bf16 model). A float64 ``x`` runs the same
    formula in float64 (``torch.autograd.gradcheck``).
    """

    @staticmethod
    def forward(ctx, x, mesh):
        xw = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, meansq, count = batch_moments(xw, mesh)
        var = meansq - mean * mean
        live = var >= 0  # clamp_min passes the gradient where it clamped nothing
        var = var.clamp_min(0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        ctx.save_for_backward(x, mean, rstd, live, count)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return ((xw - mean[:, None, None]) * rstd[:, None, None]).to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        with annotate("bn_backward"):
            x, mean, rstd, live, count = ctx.saved_tensors
            c, xw, gw = mean.shape[0], x.to(mean.dtype), g.to(mean.dtype)
            sums = torch.cat([gw.sum(dim=(0, 2, 3), dtype=torch.float64),
                              (gw * (xw - mean[:, None, None])).sum(dim=(0, 2, 3), dtype=torch.float64)])
            if ctx.mesh is not None:
                ctx.mesh.all_reduce_(sums)
            r = rstd.double()
            g_var = torch.where(live, -0.5 * r ** 3 * sums[c:], 0.0)
            g_mean = -r * sums[:c] - 2 * mean.double() * g_var
            # The statistics' cotangents per element: d mean / dx = 1 / n, d meansq / dx = 2 x / n.
            a, b = ((v / count).to(mean.dtype)[:, None, None] for v in (g_mean, g_var))
            return (gw * rstd[:, None, None]).to(x.dtype) + (a + 2 * (b * xw)).to(x.dtype), None
