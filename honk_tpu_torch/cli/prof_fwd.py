"""One leg of the frontend + res8 forward, timed (counterpart of ``prof_fwd2.py``).

    python -m honk_tpu_torch.cli.prof_fwd {xla|pmfcc|mk|mfcc_only|pmfcc_only}     # on the card
    python -m honk_tpu_torch.cli.prof_fwd xla --device cpu

A float32 res8 (weights from a seeded generator) on ``BATCH`` 1024
utterances of ``N(0, 0.1^2)`` from ``default_rng(0)``. The reference's legs
map to the card so:

- ``xla`` (XLA's ``compute_mfccs`` then flax's ``apply``):
  ``mfcc_kernel.mfcc_plain`` (the GEMM-DFT formulation on cuBLAS, TF32
  off), then ``model._folded_stack`` in float32 (cuDNN's convs, BN folded
  once): the library path with no hand-written kernel;
- ``pmfcc`` (the Pallas MFCC, then flax): the MFCC kernel, then
  ``_folded_stack``;
- ``mk`` (XLA's MFCC, then the Pallas res kernel ``res_forward_fused``):
  ``mfcc_plain``, then ``ops.res_forward_fused`` (one launch of the res
  stack in its ``bfloat16`` mode, the reference's default operand type,
  a float32 stem inside);
- ``mfcc_only``: ``mfcc_plain``; ``pmfcc_only``: the MFCC kernel.

A link is the reference's scan body, ``acc = sum(fn(audio + acc 1e-12)) *
1e-9``; chains of 10 and 40 links, each fenced once by ``.item()``
(``cli.bench.marginal``: one untimed chain of each length, then 3 reps).
The reference's "compile" lines are the seconds of those first two chains,
which include a kernel's build at its first use (``ops/_build``). Prints
the reference's lines.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable

import numpy as np
import torch

from . import bench

LEGS = ("xla", "pmfcc", "mk", "mfcc_only", "pmfcc_only")
CHAINS = (10, 40)
REPS = 3
BATCH = 1024


def make_audio(batch: int, device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy((rng.standard_normal((batch, 16000)) * 0.1).astype(np.float32)).to(device)


def make_forwards(model: torch.nn.Module) -> dict[str, Callable]:
    """``{leg: audio -> output}`` for a float32 res8 / res26, operands prepared once."""
    from ..frontend.mfcc import compute_mfccs
    from ..ops.mfcc_kernel import mfcc_plain
    from ..ops.res_kernel import fold_bn, pack_res_params, res_forward_fused

    model.eval()
    with torch.no_grad():
        folded = fold_bn(model)
        fused_ops = pack_res_params(model, torch.bfloat16)

    def stack(f):
        return model._folded_stack(f, torch.float32, *folded)

    return {
        "xla": lambda a: stack(mfcc_plain(a)),
        "pmfcc": lambda a: stack(compute_mfccs(a)),
        "mk": lambda a: res_forward_fused(model, mfcc_plain(a), packed=fused_ops),
        "mfcc_only": mfcc_plain,
        "pmfcc_only": compute_mfccs,
    }


def make_link(fn: Callable, audio: torch.Tensor) -> Callable:
    """``link(i, acc) -> acc``: the reference's scan body."""

    @torch.no_grad()
    def link(i: int, acc: torch.Tensor) -> torch.Tensor:
        return fn(audio + acc * 1e-12).sum() * 1e-9

    return link


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.prof_fwd", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("which", choices=LEGS)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    use_full_f32()
    B = BATCH
    model = bench.make_model("res8", torch.float32, device)
    run = bench.make_infer_run(make_link(make_forwards(model)[args.which], make_audio(B, device)), device)
    times: list[float] = []
    t, _ = bench.marginal(bench.recorded(run, times), CHAINS, REPS)
    print(f"compile short {times[0]:.1f}s", flush=True)
    print(f"compile long {times[1]:.1f}s", flush=True)
    for r in range(REPS):
        ts, tl = times[2 + 2 * r:4 + 2 * r]
        print(f"  rep {r}: short={ts:.3f}s long={tl:.3f}s marginal={(tl - ts) / (CHAINS[1] - CHAINS[0]) * 1e3:.3f}ms",
              flush=True)
    print(f"{args.which}: {t*1e3:.3f} ms/iter ({B/t:.0f} audio-s/s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
