"""Sainath & Parada CNN family as an ``nn.Module`` (counterpart of ``honk_tpu.models.cnn``).

Reference ``utils/model.py::SpeechModel``:

    conv1 (bias, VALID, stride conv1_stride) -> ReLU -> dropout -> max pool conv1_pool
    [conv2 -> ReLU -> dropout -> max pool conv2_pool]
    flatten (NCHW order) [-> lin] [-> dnn1 -> ReLU unless tf_variant -> dropout]
    [-> dnn2 -> dropout] -> output

Pools are max pools with window = stride and floor semantics, skipped when
(1, 1). The NCHW flatten is PyTorch's own order, so honk's dense weights load
as they are; the JAX package transposes its NHWC activations to NCHW before
its flatten for the same reason (``honk_tpu/models/cnn.py:96``). Parameter
names are honk's (``conv1.weight`` / ``bias``, ``conv2.*``, ``lin.*``,
``dnn1.*``, ``dnn2.*``, ``output.*``), so a honk ``.pt`` loads with no
converter.

The eval and training forwards run the convs and ``lin`` / ``dnn*`` in
``dtype`` (``layers.conv`` / ``layers.dense``: cuDNN convs and cuBLAS
dense layers, the JAX package has no Pallas kernel for this family either)
and the ``output`` layer in float32, as flax's ``dtype`` does: a float32
model is float32 throughout; in a bf16 one every layer returns bf16 (ReLU,
dropout and the max pools included) and the input to ``output`` is cast
to float32, as ``honk_tpu/models/cnn.py`` casts it.
``frozen_forward`` runs the float32 eval forward in either mode, for
personalization to differentiate. The training forward applies dropout with
flax's arithmetic (``layers.apply_dropout``). Its keep masks come from an explicit
generator (``keep_masks``) or from the caller; each has the NCHW shape of
the activation it drops, where flax's has the NHWC shape of the same tensor.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Output, apply_dropout, conv, dense, draw_keep_masks


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


def _conv_maps(cfg: dict[str, Any]) -> tuple[list[tuple[int, int, int]], tuple[int, int]]:
    """(C, T, F) of each conv's output before its pool, and (T, F) after the last pool."""
    t, f = cfg["height"], cfg["width"]
    maps = []
    for k in ("1", "2") if "n_feature_maps2" in cfg else ("1",):
        t = _conv_out(t, cfg[f"conv{k}_size"][0], cfg[f"conv{k}_stride"][0])
        f = _conv_out(f, cfg[f"conv{k}_size"][1], cfg[f"conv{k}_stride"][1])
        maps.append((cfg[f"n_feature_maps{k}"], t, f))
        t, f = t // cfg[f"conv{k}_pool"][0], f // cfg[f"conv{k}_pool"][1]
    return maps, (t, f)


class SpeechModel(nn.Module):
    """CNN keyword spotter. Input: (B, 101, 40) MFCC -> (B, n_labels) logits.

    ``dtype`` is the compute dtype of the convs, the hidden dense layers and
    their activations (flax's ``dtype``), in training and in eval:
    ``torch.bfloat16`` or None / ``torch.float32``.
    """

    def __init__(self, config: dict[str, Any], dtype: torch.dtype | None = None):
        super().__init__()
        self.config = dict(config)
        self.dtype = dtype or torch.float32
        self.tf_variant = bool(config.get("tf_variant", False))
        self.keep_prob = 1.0 - config.get("dropout_prob", 0.5)
        self.conv1 = nn.Conv2d(1, config["n_feature_maps1"], tuple(config["conv1_size"]),
                               stride=tuple(config["conv1_stride"]))
        self.pools = [tuple(config["conv1_pool"])]
        if "n_feature_maps2" in config:
            self.conv2 = nn.Conv2d(config["n_feature_maps1"], config["n_feature_maps2"],
                                   tuple(config["conv2_size"]), stride=tuple(config["conv2_stride"]))
            self.pools.append(tuple(config["conv2_pool"]))
        t, f, c = self.feature_shape(config)
        width = t * f * c
        for name in ("lin", "dnn1", "dnn2"):
            if f"{name}_size" in config:
                self.add_module(name, nn.Linear(width, config[f"{name}_size"]))
                width = config[f"{name}_size"]
        self.output = Output(width, config["n_labels"])

    @staticmethod
    def feature_shape(cfg: dict[str, Any]) -> tuple[int, int, int]:
        """(T, F, C) after the conv stack, for converter bookkeeping."""
        maps, (t, f) = _conv_maps(cfg)
        return t, f, maps[-1][0]

    def eval_operands(self) -> None:
        """Nothing to prepare: the eval forward reads the weights as they are."""
        return None

    def dropout_shapes(self, batch: int) -> list[tuple[int, ...]]:
        """The shapes of the training forward's keep masks, in the order it applies them."""
        if self.keep_prob >= 1.0:
            return []
        maps, _ = _conv_maps(self.config)
        return [(batch, *m) for m in maps] + [
            (batch, self.config[f"{n}_size"]) for n in ("dnn1", "dnn2") if f"{n}_size" in self.config]

    def keep_masks(self, batch: int, generator: torch.Generator) -> list[torch.Tensor]:
        """The keep masks a training forward of ``batch`` utterances draws from ``generator``."""
        return draw_keep_masks(generator, self.dropout_shapes(batch), self.keep_prob)

    def _convs(self) -> list[nn.Conv2d]:
        return [self.conv1] + ([self.conv2] if hasattr(self, "conv2") else [])

    def forward(self, x: torch.Tensor, packed: Any = None,
                dropout: torch.Generator | Sequence[torch.Tensor] | None = None, mesh: Any = None) -> torch.Tensor:
        """Logits. Training mode needs ``dropout``: the generator to draw the
        keep masks from (``keep_masks``), or the masks themselves. ``packed``
        is ``eval_operands()``'s None, and ``mesh`` the res family's data mesh
        for its BN: the family has no BN, so both are taken and unused."""
        if not self.training:
            return self._layers(x, self.dtype, [])
        shapes = self.dropout_shapes(x.shape[0])
        masks: list[torch.Tensor] = []
        if isinstance(dropout, torch.Generator):
            masks = draw_keep_masks(dropout, shapes, self.keep_prob)
        elif dropout is not None:
            masks = list(dropout)
        if len(masks) != len(shapes):
            raise ValueError(f"the training forward applies {len(shapes)} dropout layers: "
                             f"pass a generator or as many keep masks, not {dropout!r}")
        return self._layers(x, self.dtype, masks)

    def frozen_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The eval forward's logits (float32, no dropout) under autograd, in
        either mode: what a fine-tune differentiates (flax's ``train=False``).
        The family has no BN, so nothing is frozen but the dropout."""
        return self._layers(x, torch.float32, [])

    def _layers(self, x: torch.Tensor, dtype: torch.dtype, masks: list[torch.Tensor]) -> torch.Tensor:
        keep = iter(masks)

        def drop(y: torch.Tensor) -> torch.Tensor:
            return apply_dropout(y, next(keep), self.keep_prob) if masks else y

        x = x[:, None]
        for layer, pool in zip(self._convs(), self.pools):
            x = drop(F.relu(conv(layer, x, dtype)))
            if pool != (1, 1):
                x = F.max_pool2d(x, pool)
        x = x.flatten(1)
        if hasattr(self, "lin"):
            x = dense(self.lin, x, dtype)
        if hasattr(self, "dnn1"):
            x = dense(self.dnn1, x, dtype)
            x = drop(x if self.tf_variant else F.relu(x))
        if hasattr(self, "dnn2"):
            x = drop(dense(self.dnn2, x, dtype))
        return self.output(x.float())
