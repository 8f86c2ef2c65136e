"""Ablation of the train step, one leg a run (counterpart of ``prof_train.py``).

    python -m honk_tpu_torch.cli.prof_train {full|noaug|fwdbwd|aug|frontend} [B]   # on the card
    python -m honk_tpu_torch.cli.prof_train fwdbwd 4 --device cpu

A bf16 res8 (``MODEL``; weights from a seeded generator), SGD at the
default ladder, ``B`` 256, a corpus of 2,048 int16 clips, 3 s of noise
and labels, then fixed audio ``N(0, 0.1^2)``, its MFCCs and labels, all
from ``default_rng(0)`` in the reference's order (``prof_train.py:25-42``).
The legs, each a chain of links:

- ``full``: the port's train step (``train.make_train_step``): draw,
  assemble (assembly kernel), MFCC (MFCC kernel), forward, backward, SGD;
- ``noaug``: the step on the fixed audio (``+ step * 1e-12``): MFCC kernel,
  forward, backward, SGD (``step.apply_batch``);
- ``fwdbwd``: forward, backward and SGD on the fixed features
  (``step.apply_features``);
- ``aug``: the step's draws and the assembly kernel alone
  (``sample_train_batch``, the counterpart of the Pallas sampler the
  reference dispatches to on the TPU), ``acc += (sum(audio) + sum(labels))
  1e-21``;
- ``frontend``: the MFCC kernel alone on the fixed audio (``+ i *
  1e-12``). The reference's ``fast=True`` tier is an XLA precision
  setting; the port has one float32 MFCC kernel (``frontend/mfcc.py``).

The three step legs update the model in place from link to link; a chain
is fenced once by ``.item()`` of its last loss (the scalar legs: of the
accumulator). Chains of 8 and 32 links, ``cli.bench.marginal``'s median
of 3 reps after one untimed chain of each; "compile" is the seconds of
those first two chains, with the kernels' builds at first use. Prints the
reference's lines.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

import numpy as np
import torch

from . import bench

LEGS = ("full", "noaug", "fwdbwd", "aug", "frontend")
CHAINS = (8, 32)
REPS = 3
N_CLIPS = 2048
KEY = 1
MODEL = "res8"


def make_setup(name: str, dtype: torch.dtype, batch: int, device: torch.device, n_clips: int | None = None,
               model: torch.nn.Module | None = None) -> dict:
    """The reference's state, corpus and fixed batch on ``device``: ``n_clips``
    clips (``N_CLIPS`` as the module holds it when None), ``model``, if given,
    in place of a seeded one."""
    from ..data import AugmentConfig, prepare_train_arrays
    from ..frontend.mfcc import compute_mfccs
    from ..train import create_train_state, make_optimizer, make_train_step

    n_clips = N_CLIPS if n_clips is None else n_clips
    rng = np.random.default_rng(0)
    model = (bench.make_model(name, dtype, device) if model is None else model).to(device)
    tx = make_optimizer()
    aug = AugmentConfig()
    audio = rng.integers(-3000, 3000, (n_clips, 16000), dtype=np.int16)
    noise = rng.standard_normal(16000 * 3).astype(np.float32) * 0.05
    labels = rng.integers(0, 12, (n_clips,), dtype=np.int32)
    fixed_audio = torch.from_numpy((rng.standard_normal((batch, 16000)) * 0.1).astype(np.float32)).to(device)
    fixed_labels = torch.from_numpy(rng.integers(0, 12, (batch,), dtype=np.int32)).long().to(device)
    with torch.no_grad():
        fixed_feats = compute_mfccs(fixed_audio)
    return {
        "state": create_train_state(model, tx), "aug": aug, "batch": batch,
        "arrays": prepare_train_arrays(audio, labels, noise, aug, device=device),
        "step": make_train_step(tx, batch, aug), "fixed_audio": fixed_audio,
        "fixed_feats": fixed_feats, "fixed_labels": fixed_labels,
    }


def make_leg(which: str, s: dict) -> tuple[str, Callable]:
    """``("state", fn() -> loss)``, one step on the set-up's state, or
    ``("scalar", link(i, acc) -> acc)``."""
    from ..data.augment import sample_train_batch, step_generator
    from ..frontend.mfcc import compute_mfccs

    state, step = s["state"], s["step"]
    if which == "full":
        return "state", lambda: step(state, KEY, s["arrays"])[1]["loss"]
    if which == "noaug":
        return "state", lambda: step.apply_batch(state, s["fixed_audio"] + state.step * 1e-12,
                                                 s["fixed_labels"])[1]["loss"]
    if which == "fwdbwd":
        return "state", lambda: step.apply_features(state, s["fixed_feats"], s["fixed_labels"])[1]["loss"]

    @torch.no_grad()
    def aug(i: int, acc: torch.Tensor) -> torch.Tensor:
        gen = step_generator(KEY, i, s["arrays"].pool.device)
        audio, labels = sample_train_batch(gen, s["arrays"], s["batch"], s["aug"])
        return acc + (audio.sum() * 1e-9 + labels.sum() * 1e-9) * 1e-12

    @torch.no_grad()
    def frontend(i: int, acc: torch.Tensor) -> torch.Tensor:
        return acc + compute_mfccs(s["fixed_audio"] + i * 1e-12).sum() * 1e-9 * 1e-12

    if which == "aug":
        return "scalar", aug
    if which == "frontend":
        return "scalar", frontend
    raise ValueError(f"prof_train's legs are {LEGS}, not {which!r}")


def make_run(kind: str, fn: Callable, device: torch.device) -> Callable:
    """``run(length, seed) -> seconds`` of a chain of ``length`` links."""
    if kind == "scalar":
        return bench.make_infer_run(fn, device)

    def run(length: int, seed: float) -> float:
        t0 = time.perf_counter()
        for _ in range(length):
            loss = fn()
        loss.item()
        return time.perf_counter() - t0

    return run


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.prof_train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("which", choices=LEGS)
    p.add_argument("B", nargs="?", type=int, default=256)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    use_full_f32()
    s = make_setup(MODEL, torch.bfloat16, args.B, device)
    times: list[float] = []
    t, _ = bench.marginal(bench.recorded(make_run(*make_leg(args.which, s), device), times), CHAINS, REPS)
    print(f"compile short {times[0]:.1f}s", flush=True)
    print(f"compile long {times[1]:.1f}s", flush=True)
    print(f"{args.which}: B={args.B} per-step {t*1e3:.3f} ms -> {args.B/t:,.0f} audio-s/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
