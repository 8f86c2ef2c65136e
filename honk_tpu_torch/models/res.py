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

The eval forward runs conv0, ReLU and the pool as PyTorch ops (the JAX
package leaves them to XLA outside its kernel too) and the rest through
the res-stack kernel's wrapper. The training forward and res15's dilated
convolutions come with later slices of the port.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.res_kernel import pack_res_params, res_stack


class SpeechResModel(nn.Module):
    """Residual keyword spotter. Input: (B, 101, 40) MFCC -> (B, n_labels) logits."""

    def __init__(self, config: dict[str, Any]):
        super().__init__()
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
        """Eval-mode logits; ``packed`` is ``pack_res_params(self)``, computed here if None."""
        if self.training:
            raise NotImplementedError(
                "the training forward comes with the port's training slice; call .eval()"
            )
        if packed is None:
            packed = pack_res_params(self)
        return res_stack(self.stem(x), *packed)
