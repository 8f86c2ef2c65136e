"""Tang & Lin residual KWS family as an ``nn.Module`` (counterpart of ``honk_tpu.models.res``).

Architecture per layer i in 0..n_layers (reference ``utils/model.py::SpeechResModel``):

    y = relu(conv_i(x))            # 3x3, bias-free
    i == 0: optional avg-pool (res8: 4x3, res26: 2x2); old_x = y
    i  > 0 and i even: x = y + old_x; old_x = x      (identity residual)
    else:              x = y
    i  > 0: x = batchnorm_i(x)     # affine-free, AFTER the add

then the global mean over (time, freq) and a Dense(n_maps -> n_labels).

Parameter names are honk's state-dict names (``conv{i}.weight``,
``bn{i}.running_mean`` / ``running_var``, ``output.weight`` / ``bias``), so
a honk ``.pt`` loads with no converter (``torch_compat``).

The eval forward (``model.eval()``) runs conv0, ReLU and the pool as
PyTorch ops (the JAX package leaves them to XLA outside its kernel too) and
the rest through the res-stack kernel's wrapper, in float32.

The training forward (``model.train()``) is plain PyTorch with autograd:
the convolutions go through cuDNN (the JAX package has no Pallas kernel for
them either), in ``dtype`` (bfloat16 operands, float32 out) or float32.
BN uses batch statistics with flax's semantics (``honk_tpu/models/res.py``):
the biased batch variance as ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-5,
in float32, and running statistics updated by hand,
``r = 0.9 * r + 0.1 * batch`` with the *biased* variance (``nn.BatchNorm2d``
would use the unbiased one). Params, BN, the mean, the Dense and the loss
stay float32. res15's dilated convolutions come with a later slice.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.res_kernel import BN_EPS, pack_res_params, res_stack

BN_MOMENTUM = 0.9  # flax's convention: r = momentum * r + (1 - momentum) * batch


class SpeechResModel(nn.Module):
    """Residual keyword spotter. Input: (B, 101, 40) MFCC -> (B, n_labels) logits.

    ``dtype`` is the operand dtype of the training convolutions (flax's
    ``dtype``): ``torch.bfloat16`` or None / ``torch.float32``.
    """

    def __init__(self, config: dict[str, Any], dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        if config.get("use_dilation"):
            raise NotImplementedError(
                "dilated res models (res15, res15-narrow) come with the port's "
                "model-family slice (res15 / res26 / cnn-*, ROADMAP.md)"
            )
        self.n_maps = config["n_feature_maps"]
        self.n_layers = config["n_layers"]
        self.pool = tuple(config["res_pool"]) if "res_pool" in config else None
        self.conv0 = nn.Conv2d(1, self.n_maps, 3, padding=1, bias=False)
        for i in range(1, self.n_layers + 1):
            self.add_module(f"conv{i}", nn.Conv2d(self.n_maps, self.n_maps, 3, padding=1, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(self.n_maps, affine=False))
        self.output = nn.Linear(self.n_maps, config["n_labels"])

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv0 -> ReLU -> pool: (B, 101, 40) -> (B, C, H, W), the res stack's input."""
        y = F.relu(self.conv0(x[:, None]))
        if self.pool is not None:
            y = F.avg_pool2d(y, self.pool)
        return y.contiguous()

    def forward(self, x: torch.Tensor, packed: tuple[torch.Tensor, ...] | None = None) -> torch.Tensor:
        """Logits. Eval mode: ``packed`` is ``pack_res_params(self)``, computed here if None.

        Training mode also updates the BN running statistics in place.
        """
        if self.training:
            return self._train_forward(x)
        if packed is None:
            packed = pack_res_params(self)
        return res_stack(self.stem(x), *packed)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return conv(x)
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), padding=1).float()

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self._conv(self.conv0, x[:, None]))
        if self.pool is not None:
            y = F.avg_pool2d(y, self.pool)
        x = old = y
        for i in range(1, self.n_layers + 1):
            y = F.relu(self._conv(getattr(self, f"conv{i}"), x))
            if i % 2 == 0:
                x = old = y + old
            else:
                x = y
            x = batch_norm_train(x, getattr(self, f"bn{i}"))
        return self.output(x.mean(dim=(2, 3)))


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Affine-free BN of (B, C, H, W) with batch statistics, flax semantics; updates ``bn``'s buffers."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    return (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]


@torch.no_grad()
def init_weights(model: SpeechResModel, generator: torch.Generator) -> SpeechResModel:
    """The JAX package's initialisation, drawn from ``generator``.

    Conv and Dense kernels: uniform in +-1/sqrt(fan_in) (flax's
    ``variance_scaling(1/3, "fan_in", "uniform")``, which is also torch's
    default for these layers); Dense bias 0 (flax's default); BN running
    mean 0, variance 1.
    """
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            bound = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.rand(p.shape, generator=generator, device=generator.device) * (2 * bound) - bound)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return model
