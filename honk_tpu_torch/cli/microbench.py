"""Frontend / model / full forward decomposition (counterpart of ``scripts/tpu_microbench.py``).

    python -m honk_tpu_torch.cli.microbench [batch] [model]          # on the card
    python -m honk_tpu_torch.cli.microbench 4 res8-narrow --device cpu

The reference's arguments and defaults: ``batch`` 1024, ``model`` res8 (a
float32 model; weights here from a seeded generator), audio
``N(0, 0.2^2)`` and features ``N(0, 1)`` from ``default_rng(0)`` in the
reference's order. Four legs, each a chain of links ``c -> |out[0, 0(, 0)]|
+ 1`` on ``x + c * 1e-12``; the reference's labels map to the card so:

- ``frontend_jnp`` (XLA's ``compute_mfccs``): ``mfcc_kernel.mfcc_plain``,
  the same GEMM-DFT formulation as torch ops on cuBLAS, float32 with TF32
  off (``use_full_f32``);
- ``frontend_pallas`` (the Pallas MFCC): the MFCC kernel
  (``frontend.mfcc.compute_mfccs``);
- ``{model}_model_only`` (flax's ``apply``): ``model(feats)``, the float32
  eval forward (res8 / res26: one launch of the res-stack kernel's float32
  mode, conv0 and the pool inside; res15 / cnn-*: cuDNN);
- ``{model}_full_fwd``: ``model(compute_mfccs(audio))``, the port's path.

A leg's time is ``cli.bench.marginal`` between chains of ``CHAINS`` (the
reference's 100 and 300 links) after one untimed chain of each length: the
median of ``REPS`` 3 reps, where the reference takes one after warming up
on 3 links (a single marginal can come out non-positive at small sizes).
Prints one line a leg in the reference's format: ms per batch and audio-s
per s.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable

import numpy as np
import torch

from . import bench

CHAINS = (100, 300)
REPS = 3


def make_inputs(batch: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's audio (B, 16000) and features (B, 101, 40), in its draw order."""
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((batch, 16000)) * 0.2).astype(np.float32)
    feats = rng.standard_normal((batch, 101, 40)).astype(np.float32)
    return torch.from_numpy(audio).to(device), torch.from_numpy(feats).to(device)


def make_legs(model: torch.nn.Module, name: str, audio: torch.Tensor,
              feats: torch.Tensor) -> dict[str, tuple[Callable, torch.Tensor]]:
    """``{label: (fn, x)}``: each leg's function and the input its chain perturbs."""
    from ..frontend.mfcc import compute_mfccs
    from ..ops.mfcc_kernel import mfcc_plain

    model.eval()
    with torch.no_grad():
        packed = model.eval_operands()

    def model_only(f):
        return model(f, packed=packed)

    def full(a):
        return model(compute_mfccs(a), packed=packed)

    return {
        "frontend_jnp": (mfcc_plain, audio),
        "frontend_pallas": (compute_mfccs, audio),
        f"{name}_model_only": (model_only, feats),
        f"{name}_full_fwd": (full, audio),
    }


def make_link(fn: Callable, x: torch.Tensor) -> Callable:
    """``link(i, c) -> c``: the reference's dependent link, ``|fn(x + c 1e-12)[0, 0(, 0)]| + 1``."""

    @torch.no_grad()
    def link(i: int, c: torch.Tensor) -> torch.Tensor:
        out = fn(x + c * 1e-12)
        return out.reshape(out.shape[0], -1)[0, 0].abs() + 1.0

    return link


def line(label: str, t: float, batch: int) -> str:
    """The reference's line for one leg (``scripts/tpu_microbench.py:82``)."""
    return f"{label:>18}: {t*1e3:7.3f} ms/batch  {batch/t:12,.0f} audio-s/s"


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.microbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("batch", nargs="?", type=int, default=1024)
    p.add_argument("model", nargs="?", default="res8")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    use_full_f32()
    audio, feats = make_inputs(args.batch, device)
    model = bench.make_model(args.model, torch.float32, device)
    for label, (fn, x) in make_legs(model, args.model, audio, feats).items():
        t, _ = bench.marginal(bench.make_infer_run(make_link(fn, x), device), CHAINS, REPS)
        print(line(label, t, args.batch), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
