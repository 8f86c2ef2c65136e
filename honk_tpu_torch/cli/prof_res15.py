"""Where res15's train step spends its time, probe by probe (counterpart of ``scripts/prof_res15.py``).

    python -m honk_tpu_torch.cli.prof_res15 [--batch 256] [--reps 5] [--short 8] [--long 40] [--out FILE]
    python -m honk_tpu_torch.cli.prof_res15 --batch 2 --reps 1 --short 1 --long 2 --device cpu

res15 is 13 dilated 3x3 convs of 45 maps on unpooled 101 x 40 maps; the
port runs them through cuDNN in bf16 (flax's dtype flow), as the JAX
package runs them through XLA. The probes, in the reference's order and
under its keys:

- one bf16 conv of 45 maps at dilation 1, 2, 4, 8 and 16, forward
  (``layers.conv``, then ``+ x * 1e-6``), and forward + both gradients
  (weights and input) of its float32 sum;
- the same conv at d=1 with 45, 64 and 128 maps;
- affine-free train-mode BN (``models.res.batch_norm_train``: float32
  batch statistics, bf16 out) plus ``x * 1e-6``;
- a bf16 res15's eval forward on (B, 101, 40) features (BN folded once,
  ``model.eval_operands()``) and its train step (``train.make_train_step``:
  draw, assembly kernel, MFCC kernel, forward, backward, SGD) on a seeded
  corpus of 2,048 clips;
- the implied TFLOP/s of the convs and the step, by the reference's
  counts.

Activations are NCHW, as the port's models hold them: the reference ran
NHWC (flax's layout). Its inputs are drawn in NHWC from ``default_rng(0)``
in its order and transposed, so each probe sees the reference's values.
A probe is a chain of links carrying its output to the next, fenced once by
``.item()`` of a float32 sum; its time is ``cli.bench.marginal`` between
``--short`` and ``--long`` links, the median of ``--reps`` reps after one
untimed chain of each. Weights come from a seeded generator. Prints one
JSON line with the reference's keys (written to ``--out`` too, where
given); ``device`` is the card's name.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from . import bench

T, F = 101, 40
MAPS = 45
DILATIONS = (1, 2, 4, 8, 16)
KEY = 1
MODEL = "res15"
MODEL_FLOPS = 1788e6 + 47e6  # the reference's res15 and frontend multiply-adds per utterance, x2


def parse(prog: str, doc: str, argv: list[str] | None, **extra) -> argparse.Namespace:
    """The reference probes' arguments, with ``--device``."""
    p = argparse.ArgumentParser(prog=prog, description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    for flag, default in extra.items():
        p.add_argument(f"--{flag}", default=default)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--short", type=int, default=8)
    p.add_argument("--long", type=int, default=40)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(sys.argv[1:] if argv is None else argv)


def nchw(rng: np.random.Generator, batch: int, maps: int, device: torch.device) -> torch.Tensor:
    """bf16 activations drawn as the reference draws them, NHWC, held NCHW."""
    x = torch.from_numpy(rng.standard_normal((batch, T, F, maps)).astype(np.float32))
    return x.permute(0, 3, 1, 2).contiguous().to(device, torch.bfloat16)


def conv_layer(d: int, maps: int, device: torch.device, seed: int = 0) -> nn.Conv2d:
    """A bias-free 3x3 conv at dilation ``d``, weights LeCun-normal from a seeded generator."""
    layer = nn.Conv2d(maps, maps, 3, padding=d, dilation=d, bias=False)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=g) / math.sqrt(9 * maps))
    return layer.to(device)


def carry_run(body: Callable, x: torch.Tensor) -> Callable:
    """``run(length, seed) -> seconds``: ``length`` links of ``body`` from ``x``, fenced by a float32 sum."""

    def run(length: int, seed: float) -> float:
        t0 = time.perf_counter()
        y = x
        for _ in range(length):
            y = body(y)
        y.float().sum().item()
        return time.perf_counter() - t0

    return run


def step_run(step: Callable, state, arrays, keys: Callable[[int], int] = lambda i: KEY) -> Callable:
    """``run(length, seed) -> seconds``: ``length`` train steps, fenced by the last loss."""

    def run(length: int, seed: float) -> float:
        t0 = time.perf_counter()
        for i in range(length):
            _, m = step(state, keys(i), arrays)
        m["loss"].item()
        return time.perf_counter() - t0

    return run


def train_inputs(rng: np.random.Generator, batch: int, device: torch.device):
    """The reference's train-step corpus: (AugmentConfig, TrainArrays) of 2,048 clips."""
    from ..data import AugmentConfig, prepare_train_arrays

    aug = AugmentConfig(n_silence=batch // 10)
    audio = rng.integers(-3000, 3000, (2048, 16000), dtype=np.int16)
    noise = (rng.standard_normal(16000 * 40) * 0.05).astype(np.float32)
    labels = rng.integers(2, 12, (2048,), dtype=np.int32)
    return aug, prepare_train_arrays(audio, labels, noise, aug, device=device)


def conv_fwd(layer: nn.Conv2d) -> Callable:
    from ..models.layers import conv

    @torch.no_grad()
    def body(x):
        return conv(layer, x, torch.bfloat16) + x * 1e-6

    return body


def conv_fwdbwd(layer: nn.Conv2d) -> Callable:
    from ..models.layers import conv

    def body(x):
        x = x.detach().requires_grad_()
        gw, gx = torch.autograd.grad(conv(layer, x, torch.bfloat16).float().sum(), (layer.weight, x))
        with torch.no_grad():
            return gx + x * 1e-6 + gw.to(torch.bfloat16).sum() * 1e-9

    return body


def probe(args: argparse.Namespace, device: torch.device) -> dict:
    from ..models.res import batch_norm_train
    from ..train import create_train_state, make_optimizer, make_train_step

    B = args.batch
    rng = np.random.default_rng(0)
    x0 = nchw(rng, B, MAPS, device)

    def ms(run: Callable) -> float:
        return bench.marginal(run, (args.short, args.long), args.reps)[0] * 1e3

    results = {"batch": B, "device": bench.device_name(device)}
    conv_ms = {d: ms(carry_run(conv_fwd(conv_layer(d, MAPS, device)), x0)) for d in DILATIONS}
    results["conv45_fwd_ms_by_dilation"] = {str(k): round(v, 4) for k, v in conv_ms.items()}
    convb_ms = {d: ms(carry_run(conv_fwdbwd(conv_layer(d, MAPS, device)), x0)) for d in DILATIONS}
    results["conv45_fwdbwd_ms_by_dilation"] = {str(k): round(v, 4) for k, v in convb_ms.items()}
    conv_flops3 = B * T * F * MAPS * MAPS * 9 * 2 * 3  # fwd + dgrad + wgrad
    results["conv45_fwdbwd_implied_tflops_by_dilation"] = {
        str(d): round(conv_flops3 / (convb_ms[d] * 1e-3) / 1e12, 1) for d in convb_ms
    }
    ch_ms = {}
    for maps in (45, 64, 128):
        xm = nchw(rng, B, maps, device)
        ch_ms[maps] = ms(carry_run(conv_fwd(conv_layer(1, maps, device)), xm))
        del xm
    results["conv_fwd_ms_by_maps_d1"] = {str(k): round(v, 4) for k, v in ch_ms.items()}

    bn = nn.BatchNorm2d(MAPS, affine=False).to(device)

    @torch.no_grad()
    def bn_body(x):
        return batch_norm_train(x, bn) + x * 1e-6

    results["bn_residual_ms"] = round(ms(carry_run(bn_body, x0)), 4)

    model = bench.make_model(MODEL, torch.bfloat16, device).eval()
    with torch.no_grad():
        packed = model.eval_operands()
    feats = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)).to(device)

    @torch.no_grad()
    def fwd_body(c):
        return c + model(c * 1.0, packed=packed).mean() * 1e-6

    results["res15_fwd_ms"] = round(ms(carry_run(fwd_body, feats)), 4)
    aug, arrays = train_inputs(rng, B, device)
    tx = make_optimizer()
    state = create_train_state(bench.make_model(MODEL, torch.bfloat16, device), tx)
    results["res15_train_step_ms"] = round(ms(step_run(make_train_step(tx, B, aug), state, arrays)), 4)

    conv_flops = B * T * F * MAPS * MAPS * 9 * 2  # one 3x3 conv, fwd
    results["conv45_implied_tflops_by_dilation"] = {
        str(d): round(conv_flops / (conv_ms[d] * 1e-3) / 1e12, 1) for d in conv_ms
    }
    results["res15_train_implied_tflops"] = round(
        (B * MODEL_FLOPS * 3) / (results["res15_train_step_ms"] * 1e-3) / 1e12, 1
    )
    return results


def emit(results: dict, out: str) -> None:
    """The reference's one JSON line, on stdout and in ``out`` where given."""
    line = json.dumps(results)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32

    args = parse("honk_tpu_torch.cli.prof_res15", __doc__, argv)
    device = resolve_device(args.device)
    use_full_f32()
    emit(probe(args, device), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
