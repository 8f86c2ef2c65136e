"""res15's train step: one launch sequence a step against the folded scan (counterpart of ``scripts/prof_res15_dispatch.py``).

    python -m honk_tpu_torch.cli.prof_res15_dispatch [--batch 256] [--model res15] [--reps 5] [--short 8] [--long 40]
    python -m honk_tpu_torch.cli.prof_res15_dispatch --batch 2 --model res15-narrow --reps 1 --short 1 --long 2 --device cpu

A bf16 ``--model`` (weights from a seeded generator) trained on a seeded
corpus of 2,048 clips (the reference's draws, ``default_rng(0)``), two
legs in one process, each from a fresh state:

- ``scan_carry_ms_per_step`` (the reference's ``make_train_scan``, the
  weights a ``lax.scan`` carry): the port's ``train.make_train_scan`` of
  ``--short`` and ``--long`` steps, one call a chain, fenced by its mean
  loss;
- ``step_dispatch_ms_per_step`` (one jitted program a step, the state
  donated): ``train.make_train_step`` called once a step with its own key,
  fenced by the last loss.

PyTorch launches eagerly, so both legs launch the same kernels a step from
the same Python loop; the scan adds only the stacking of its metrics. What
the reference's third leg measures, XLA's choice of layouts for the state
(``Layout.AUTO``) against a scan carry's fixed one, has no counterpart: the
port's weights keep PyTorch's one layout and no compiler chooses another.
So ``auto_layout_nondefault_leaves``, ``auto_layout_total_leaves``,
``step_dispatch_auto_layout_ms_per_step``, ``speedup_auto_vs_scan`` and
``train_audio_s_per_s_auto`` are null. Timing as ``cli.prof_res15``.
Prints one JSON line with the reference's keys (to ``--out`` too).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import bench
from .prof_res15 import emit, parse, step_run, train_inputs


def probe(args, device: torch.device) -> dict:
    from ..train import create_train_state, make_optimizer, make_train_scan, make_train_step

    B = args.batch
    rng = np.random.default_rng(0)
    aug, arrays = train_inputs(rng, B, device)
    tx = make_optimizer()
    keys = np.random.default_rng(1).integers(0, 2**31 - 1, args.long).tolist()
    lens = (args.short, args.long)

    def fresh():
        return create_train_state(bench.make_model(args.model, torch.bfloat16, device), tx)

    def ms(run) -> float:
        return round(bench.marginal(run, lens, args.reps)[0] * 1e3, 3)

    results = {"batch": B, "model": args.model, "device": bench.device_name(device)}
    scans = {n: make_train_scan(tx, B, aug, n) for n in lens}
    state = fresh()

    def run_scan(length: int, seed: float) -> float:
        t0 = time.perf_counter()
        _, m = scans[length](state, keys[0], arrays)
        m["loss"].item()
        return time.perf_counter() - t0

    results["scan_carry_ms_per_step"] = ms(run_scan)
    results["step_dispatch_ms_per_step"] = ms(step_run(make_train_step(tx, B, aug), fresh(), arrays,
                                                       keys=lambda i: keys[i]))
    results["auto_layout_nondefault_leaves"] = None
    results["auto_layout_total_leaves"] = None
    results["step_dispatch_auto_layout_ms_per_step"] = None
    a, b = results["scan_carry_ms_per_step"], results["step_dispatch_ms_per_step"]
    results["speedup_step_vs_scan"] = round(a / b, 3)
    results["speedup_auto_vs_scan"] = None
    results["train_audio_s_per_s_scan"] = round(B / (a * 1e-3), 1)
    results["train_audio_s_per_s_step"] = round(B / (b * 1e-3), 1)
    results["train_audio_s_per_s_auto"] = None
    return results


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32

    args = parse("honk_tpu_torch.cli.prof_res15_dispatch", __doc__, argv, model="res15")
    if not 0 < args.short < args.long:
        raise SystemExit(f"need 0 < --short ({args.short}) < --long ({args.long}): "
                         "the marginal divisor is (long - short) and the key list holds `long` entries")
    device = resolve_device(args.device)
    use_full_f32()
    emit(probe(args, device), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
