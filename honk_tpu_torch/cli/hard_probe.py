"""Difficulty probe for the hard-mode corpus (counterpart of ``scripts/hard_probe.py``).

    python -m honk_tpu_torch.cli.hard_probe --epochs 8 \\
        --variants '[{"snr_db":[0,12],"speaker_spread":0.15,"formant_jitter":0.035}]'
    python -m honk_tpu_torch.cli.hard_probe --epochs 1 --batch 8 --clips_per_word 2 --n_speakers 2 \\
        --models res8-narrow --root <dir> --device cpu

Trains bf16 models for a few epochs on several ``data.generate_hard_dataset``
variants in one process. The reference caches each model's step and sweep
across variants to reuse its compiled programs; the port compiles nothing
and makes them per run. Each
variant is generated into ``<root>_<i>`` unless it is there. A run is the
port's ``train.make_train_scan`` of one epoch a call (draw, assembly
kernel, MFCC kernel, forward, backward, SGD a step, ``key = seed + 1``;
each step's draws come from the key and the step count) and a dev sweep
after each epoch (``train.make_eval_sweep(256)``: the MFCC kernel and the
bf16 eval forward, for res8 / res26 the res-stack kernel's
``bfloat16_activations`` mode). Weights are ``init_weights`` from
``--seed``; the lr ladder's boundaries default to a third and two thirds
of the run. ``--root``'s default is the reference's ``/tmp/hard_probe``,
under the process's temporary directory.

Prints the reference's JSON lines: ``{"variant", "generated_s"}`` after a
generation, ``{"variant", "model", "epoch", "loss", "train_acc",
"dev_acc", "wall_s"}`` per epoch and ``{"variant", "model", "knobs",
"dev_curve", "final_dev", "best_dev"}`` per variant and model.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device, use_full_f32
    from ..data import AugmentConfig, generate_hard_dataset, load_speech_commands, prepare_train_arrays
    from ..models import find_config, find_model, init_weights
    from ..train import create_train_state, make_eval_sweep, make_optimizer, make_train_scan

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.hard_probe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--clips_per_word", type=int, default=800)
    p.add_argument("--n_speakers", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models", nargs="+", default=["res8"])
    p.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.01, 0.001])
    p.add_argument("--schedule", type=int, nargs="*", default=None,
                   help="lr boundaries in steps; default = 1/3 and 2/3 of the run")
    p.add_argument("--variants", default='[{}]',
                   help="JSON list of generate_hard_dataset knob dicts")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "hard_probe"))
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    variants = json.loads(args.variants)
    device = resolve_device(args.device)
    use_full_f32()

    for vi, knobs in enumerate(variants):
        root = f"{args.root}_{vi}"
        if not os.path.isdir(os.path.join(root, "yes")):
            t0 = time.time()
            generate_hard_dataset(
                root, clips_per_word=args.clips_per_word, n_speakers=args.n_speakers, seed=args.seed,
                **{k: tuple(v) if isinstance(v, list) else v for k, v in knobs.items()},
            )
            print(json.dumps({"variant": vi, "generated_s": round(time.time() - t0, 1)}), flush=True)
        ds = load_speech_commands(root)
        n_train = len(ds.train)
        n_sil = int(0.1 * n_train)
        aug = AugmentConfig(n_silence=n_sil)
        steps_per_epoch = max(1, math.ceil((n_train + n_sil) / args.batch))
        total_steps = steps_per_epoch * args.epochs
        schedule = tuple(args.schedule) if args.schedule is not None else (total_steps // 3, 2 * total_steps // 3)
        arrays = prepare_train_arrays(ds.train.audio, ds.train.labels, ds.noise, aug, device=device)
        dev_audio = torch.from_numpy(np.ascontiguousarray(ds.dev.audio)).to(device)
        dev_labels = torch.from_numpy(ds.dev.labels.astype(np.int64)).to(device)

        for name in args.models:
            tx = make_optimizer(lrs=tuple(args.lr), boundaries=schedule)
            scan, sweep = make_train_scan(tx, args.batch, aug, steps_per_epoch), make_eval_sweep(256)
            cfg = find_config(name)
            cfg["n_labels"] = ds.n_labels
            model = find_model(name)(cfg, dtype=torch.bfloat16)
            init_weights(model, torch.Generator().manual_seed(args.seed))
            state = create_train_state(model.to(device), tx)
            key = args.seed + 1
            curve = []
            for epoch in range(args.epochs):
                t0 = time.time()
                state, m = scan(state, key, arrays)
                c, t = sweep(state.model, dev_audio, dev_labels)
                dev = float(c) / max(float(t), 1)
                curve.append(dev)
                print(json.dumps({
                    "variant": vi, "model": name, "epoch": epoch,
                    "loss": round(float(m["loss"]), 4), "train_acc": round(float(m["acc"]), 4),
                    "dev_acc": round(dev, 4), "wall_s": round(time.time() - t0, 2),
                }), flush=True)
            print(json.dumps({
                "variant": vi, "model": name, "knobs": knobs,
                "dev_curve": [round(d, 4) for d in curve],
                "final_dev": round(curve[-1], 4), "best_dev": round(max(curve), 4),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
