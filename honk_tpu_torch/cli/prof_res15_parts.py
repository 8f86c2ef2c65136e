"""res15's train step split into its parts, part 2 (counterpart of ``scripts/prof_res15_parts.py``).

    python -m honk_tpu_torch.cli.prof_res15_parts [--batch 256] [--reps 5] [--short 8] [--long 40] [--out FILE]
    python -m honk_tpu_torch.cli.prof_res15_parts --batch 2 --reps 1 --short 1 --long 2 --device cpu

Three probes of a bf16 res15 (weights from a seeded generator) on
(B, 101, 40) features ``N(0, 1)`` from ``default_rng(0)``, each the
gradient of ``mean(logits^2)`` (float32) with respect to the weights:

- ``full_grad_train_bn_ms``: the training forward, BN from batch
  statistics (``model.train()``; the running statistics it updates are
  not read);
- ``full_grad_eval_bn_ms``: the eval forward, BN from the running
  statistics, folded (``model.eval()``; the fold is recomputed each link,
  as flax's eval BN reads the statistics each call);
- ``convstack13_grad_ms``: 13 bias-free bf16 3x3 convs of 45 maps at
  dilation ``2 ** (i // 3)`` with ReLU, no BN and no residual, on (B, 45,
  101, 40) activations.

A link computes every weight's gradient and adds ``sum(first gradient) *
1e-9`` to its input (the first of the reference's gradient leaves is
conv0's kernel; here ``conv0.weight`` or the stack's first conv).
Activations are NCHW, as the port's models hold them; the reference ran
NHWC and its activations are drawn so and transposed. Timing as ``cli.prof_res15``. Prints one JSON line with the
reference's keys (to ``--out`` too); ``device`` is the card's name.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from . import bench
from .prof_res15 import MAPS, MODEL, F, T, carry_run, conv_layer, emit, nchw, parse


def grad_body(loss: Callable, weights: list[torch.Tensor]) -> Callable:
    """``x -> x + sum(d loss(x) / d weights[0]) * 1e-9``, in ``x``'s dtype, with
    the gradient of every weight computed (eager PyTorch elides none)."""

    def body(x):
        g = torch.autograd.grad(loss(x), weights)[0]
        with torch.no_grad():
            return x + (g.float().sum() * 1e-9).to(x.dtype)

    return body


def conv_stack(device: torch.device) -> nn.ModuleList:
    """The reference's ``ConvStack``: 13 convs of 45 maps, dilation ``2 ** (i // 3)``."""
    return nn.ModuleList(conv_layer(2 ** (i // 3), MAPS, device, seed=i) for i in range(13))


def probe(args, device: torch.device) -> dict:
    from ..models.layers import conv

    B = args.batch
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)).to(device)

    def ms(run) -> float:
        return round(bench.marginal(run, (args.short, args.long), args.reps)[0] * 1e3, 3)

    results = {"batch": B, "device": bench.device_name(device)}
    model = bench.make_model(MODEL, torch.bfloat16, device)
    weights = list(model.parameters())  # conv0.weight first

    def logits_loss(x):
        return (model(x).float() ** 2).mean()

    model.train()
    results["full_grad_train_bn_ms"] = ms(carry_run(grad_body(logits_loss, weights), feats))
    model.eval()
    results["full_grad_eval_bn_ms"] = ms(carry_run(grad_body(logits_loss, weights), feats))

    stack = conv_stack(device)
    x45 = nchw(rng, B, MAPS, device)

    def stack_loss(x):
        for layer in stack:
            x = torch.relu(conv(layer, x, torch.bfloat16))
        return (x.float() ** 2).mean()

    results["convstack13_grad_ms"] = ms(carry_run(grad_body(stack_loss, list(stack.parameters())), x45))
    return results


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32

    args = parse("honk_tpu_torch.cli.prof_res15_parts", __doc__, argv)
    device = resolve_device(args.device)
    use_full_f32()
    emit(probe(args, device), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
