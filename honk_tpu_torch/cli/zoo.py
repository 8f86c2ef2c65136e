"""Build a zoo of trained models and rank them with a paired test.

Counterpart of the JAX repo's ``scripts/make_zoo.py::build_zoo`` (``build``)
and ``scripts/compare_zoo.py::main`` (``compare``):

    python -m honk_tpu_torch.cli.zoo build <zoo_dir> --models res8 res15 \\
        --data_dir data/hard_v2 --hard --n_epochs 26 --batch_size 64 --seed 0 \\
        --lr 0.1 0.01 0.001 --schedule 220 440 --dev_pct 10 --test_pct 80
    python -m honk_tpu_torch.cli.zoo compare <zoo_dir> --data_dir data/hard_v2 \\
        --dev_pct 10 --test_pct 80 [--against zoo_hard_v2]

``build`` generates the corpus into ``--data_dir`` if it has none
(``--hard``: ``data.generate_hard_dataset``'s defaults, else
``data.generate_dataset``'s), trains each model through
``train.loop.train`` at the recipe given (its dev and test sweeps in the
model's ``--compute_dtype``), writes ``<zoo_dir>/<model>.pt`` (a honk
state dict of the best-dev weights) and merges ``<zoo_dir>/MANIFEST.json``
with make_zoo's keys, refusing a manifest of another label set. The JAX
script also writes an Orbax ``<model>/`` checkpoint; the port reads Orbax
(``ckpt.orbax``) but writes none, so its entries say ``"orbax": null``.

``compare`` scores every MANIFEST model on the test split with the float32
eval forward (TF32 off, as compare_zoo's ``precision="highest"``), writes
``<model>_test_correct.npy``, ``test_acc_recheck`` and ``test_acc_se``,
and for every pair McNemar's paired test on the per-clip correctness into
``ladder_stats``: b = clips the first model gets right and the second
wrong, c the reverse, z = (b - c) / sqrt(b + c), the winner (None on a
tie) and whether |z| >= 2. ``--against <zoo>`` pairs each model in the
same way with the ``<model>_test_correct.npy`` of the same name in another
zoo on the same test split (``against_stats``), e.g. the port's models
with the JAX package's committed ``zoo_hard_v2``.

Both run on ``--device cuda`` (the default; raises where there is none)
or ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np
import torch

from ..config import DataConfig, ExperimentConfig, TrainConfig

METHOD = "paired McNemar z on shared-test per-clip correctness; |z|>=2 ~ 2 SE"


def build_zoo(out_dir: str, models: list[str], data_dir: str, n_epochs: int, batch_size: int, seed: int = 0,
              compute_dtype: str = "bfloat16", lr: tuple[float, ...] | None = None,
              schedule: tuple[int, ...] | None = None, steps_per_call: int | None = None, hard: bool = False,
              dev_pct: float = 10.0, test_pct: float = 10.0, device: str | torch.device | None = None) -> dict:
    """Train ``models`` on ``data_dir`` and merge them into ``out_dir``'s MANIFEST; returns the manifest."""
    from ..ckpt import Checkpointer
    from ..data import generate_dataset, generate_hard_dataset, load_speech_commands
    from ..train import train

    if not os.path.isdir(os.path.join(data_dir, "yes")):
        (generate_hard_dataset if hard else generate_dataset)(data_dir)
    dataset = load_speech_commands(data_dir, dev_pct=dev_pct, test_pct=test_pct)
    os.makedirs(out_dir, exist_ok=True)
    corpus_recipe = None
    recipe_path = os.path.join(data_dir, "CORPUS.json")
    if os.path.isfile(recipe_path):
        with open(recipe_path) as f:
            corpus_recipe = json.load(f)
    split_sizes = {"train": len(dataset.train), "dev": len(dataset.dev), "test": len(dataset.test)}
    manifest_path = os.path.join(out_dir, "MANIFEST.json")
    if os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest["n_labels"] != dataset.n_labels or manifest["labels"] != list(dataset.label_names):
            raise ValueError(f"existing manifest labels {manifest['labels']} != corpus labels "
                             f"{list(dataset.label_names)}; use a fresh out_dir")
        manifest.update(corpus=data_dir, corpus_recipe=corpus_recipe, split_sizes=split_sizes)
    else:
        manifest = {"corpus": data_dir, "corpus_recipe": corpus_recipe, "split_sizes": split_sizes,
                    "n_labels": dataset.n_labels, "labels": list(dataset.label_names), "models": {}}
    for name in models:
        tkw = dict(model=name, n_epochs=n_epochs, batch_size=batch_size, seed=seed, compute_dtype=compute_dtype)
        if lr is not None:
            tkw["lr"] = tuple(lr)
        if schedule is not None:
            tkw["schedule"] = tuple(schedule)
        if steps_per_call is not None:
            tkw["steps_per_call"] = steps_per_call
        cfg = ExperimentConfig(data=DataConfig(data_dir=data_dir, seed=seed, dev_pct=dev_pct, test_pct=test_pct),
                               train=TrainConfig(**tkw))
        result = train(cfg, dataset=dataset, device=device)
        Checkpointer(out_dir).save_best(result["best"], name)
        n_params = sum(p.numel() for p in result["model"].parameters())
        manifest["models"][name] = {
            "pt": f"{name}.pt",
            "orbax": None,
            "test_acc": round(float(result["test_acc"]), 4),
            "best_dev_acc": round(float(result["best_dev_acc"]), 4),
            "n_params": n_params,
            "recipe": {
                "n_epochs": n_epochs, "batch_size": batch_size, "seed": seed, "compute_dtype": compute_dtype,
                "lr": list(lr) if lr is not None else list(TrainConfig().lr),
                "schedule": list(schedule) if schedule is not None else list(TrainConfig().schedule),
                "dev_pct": dev_pct, "test_pct": test_pct, "n_test_clips": len(dataset.test),
            },
        }
        print(f"zoo: {name} test_acc={result['test_acc']:.4f} params={n_params}", flush=True)
    _write(manifest_path, manifest)
    return manifest


def mcnemar(first: np.ndarray, second: np.ndarray, a: str, b_name: str) -> dict:
    """McNemar's paired statistics of two per-clip correctness vectors, rounded as compare_zoo rounds them."""
    b = int((first & ~second).sum())  # first right, second wrong
    c = int((~first & second).sum())  # second right, first wrong
    z = (b - c) / max(np.sqrt(b + c), 1e-9)
    return {"n_only_first_correct": b, "n_only_second_correct": c, "mcnemar_z": round(float(z), 2),
            # None on an exact tie: naming either side would record an arbitrary ordering.
            "winner": None if b == c else (a if z > 0 else b_name), "resolved_2se": bool(abs(z) >= 2.0)}


@torch.no_grad()
def per_clip_correct(model: torch.nn.Module, audio: np.ndarray, labels: np.ndarray, batch: int,
                     device: torch.device) -> np.ndarray:
    """Per-clip correctness of ``model``'s eval forward on int16 ``audio`` (N, 16000), ``batch`` clips a call."""
    from ..frontend import compute_mfccs

    model = model.to(device).eval()
    packed = model.eval_operands()
    preds = [model(compute_mfccs(torch.from_numpy(audio[s:s + batch]).to(device).float() / 32768.0),
                   packed=packed).argmax(-1).cpu() for s in range(0, len(labels), batch)]
    return torch.cat(preds).numpy() == labels


def compare_zoo(zoo_dir: str, data_dir: str, dev_pct: float = 10.0, test_pct: float = 10.0, batch: int = 256,
                against: str | None = None, device: str | torch.device | None = None) -> dict:
    """Score every MANIFEST model on the test split and write the paired statistics; returns the manifest."""
    from .. import resolve_device, use_full_f32
    from ..data import load_speech_commands
    from ..models import find_config, find_model, load_honk_checkpoint

    device = resolve_device(device)
    use_full_f32()
    manifest_path = os.path.join(zoo_dir, "MANIFEST.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    ds = load_speech_commands(data_dir, dev_pct=dev_pct, test_pct=test_pct)
    labels = np.asarray(ds.test.labels)
    n = len(labels)
    correct = {}
    for name in manifest["models"]:
        cfg = find_config(name)
        cfg["n_labels"] = ds.n_labels
        model = load_honk_checkpoint(os.path.join(zoo_dir, f"{name}.pt"), find_model(name)(cfg))
        vec = per_clip_correct(model, ds.test.audio, labels, batch, device)
        correct[name] = vec
        np.save(os.path.join(zoo_dir, f"{name}_test_correct.npy"), vec)
        acc = float(vec.mean())
        se = float(np.sqrt(acc * (1 - acc) / n))
        manifest["models"][name]["test_acc_recheck"] = round(acc, 4)
        manifest["models"][name]["test_acc_se"] = round(se, 5)
        print(f"{name}: acc={acc:.4f} +- {se:.4f} (n={n})", flush=True)
    stats = {}
    for a, b_name in itertools.combinations(correct, 2):
        key = f"{a}_vs_{b_name}"
        stats[key] = mcnemar(correct[a], correct[b_name], a, b_name)
        _print_pair(key, stats[key])
    manifest["ladder_stats"] = {"n_test_clips": n, "method": METHOD, "pairwise": stats}
    if against is not None:
        pairs = {}
        for name, vec in correct.items():
            path = os.path.join(against, f"{name}_test_correct.npy")
            if not os.path.isfile(path):
                continue
            other = np.load(path)
            if other.shape != vec.shape:
                raise ValueError(f"{path}: {other.shape[0]} clips, this test split has {n}")
            pairs[name] = mcnemar(vec, other, name, os.path.join(against, name))
            _print_pair(f"{name}_vs_{os.path.join(against, name)}", pairs[name])
        manifest["against_stats"] = {"zoo": against, "n_test_clips": n, "method": METHOD, "pairwise": pairs}
    _write(manifest_path, manifest)
    return manifest


def _print_pair(key: str, s: dict) -> None:
    z = s["mcnemar_z"]
    print(f"{key}: b={s['n_only_first_correct']} c={s['n_only_second_correct']} z={z:+.2f} "
          f"{'RESOLVED' if abs(z) >= 2 else 'unresolved'}", flush=True)


def _write(path: str, manifest: dict) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.zoo", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    b = sub.add_parser("build", help="train models into a zoo (scripts/make_zoo.py)")
    b.add_argument("out_dir")
    b.add_argument("--models", nargs="+", default=["res8", "res8-narrow", "cnn-trad-pool2"])
    b.add_argument("--data_dir", default="data/speech_dataset")
    b.add_argument("--n_epochs", type=int, default=12)
    b.add_argument("--batch_size", type=int, default=64)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--compute_dtype", choices=["bfloat16", "float32"], default="bfloat16")
    b.add_argument("--lr", type=float, nargs="+", default=None)
    b.add_argument("--schedule", type=int, nargs="*", default=None)
    b.add_argument("--steps_per_call", type=int, default=None)
    b.add_argument("--hard", action="store_true", help="generate a hard-mode corpus if data_dir is missing")
    c = sub.add_parser("compare", help="score a zoo's models and rank them (scripts/compare_zoo.py)")
    c.add_argument("zoo_dir")
    c.add_argument("--data_dir", required=True)
    c.add_argument("--batch", type=int, default=256)
    c.add_argument("--against", default=None,
                   help="another zoo whose <model>_test_correct.npy each model is paired with")
    for q in (b, c):
        q.add_argument("--dev_pct", type=float, default=10.0)
        q.add_argument("--test_pct", type=float, default=10.0)
        q.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "build":
        build_zoo(args.out_dir, args.models, args.data_dir, args.n_epochs, args.batch_size, args.seed,
                  args.compute_dtype, lr=tuple(args.lr) if args.lr is not None else None,
                  schedule=tuple(args.schedule) if args.schedule is not None else None,
                  steps_per_call=args.steps_per_call, hard=args.hard, dev_pct=args.dev_pct,
                  test_pct=args.test_pct, device=args.device)
    else:
        compare_zoo(args.zoo_dir, args.data_dir, args.dev_pct, args.test_pct, args.batch, args.against,
                    args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
