"""res8 train + inference throughput in audio-seconds/s per card (counterpart of ``bench.py``).

    python -m honk_tpu_torch.cli.bench                  # on the card
    BENCH_BATCH=2 BENCH_SCAN_SHORT=1 BENCH_SCAN_LONG=4 BENCH_REPS=2 \\
        BENCH_MODEL=res8-narrow python -m honk_tpu_torch.cli.bench --device cpu

The reference's knobs and defaults: ``BENCH_BATCH`` 256, ``BENCH_SCAN_SHORT``
/ ``BENCH_SCAN_LONG`` 32 / 160 train links (inference twice those),
``BENCH_REPS`` 7, ``BENCH_MODEL`` res8, ``BENCH_DTYPE`` bfloat16. Weights
come from a seeded generator; inputs from ``default_rng(0)`` in the
reference's order, and stay on the device.

- An inference link is the reference's scan body: a rolling slice of a
  pool of ``max(2048, 2 B)`` clips plus ``acc * 1e-12``, the MFCC kernel,
  the model's eval forward (a bf16 res8: the res stack's
  ``bfloat16_activations`` mode; its operands packed once, as a sweep packs
  them), and ``acc += logits.sum()``.
- A training link is one step of ``make_train_scan`` (sample, assemble,
  MFCC, forward, backward, SGD) on ``prepare_train_arrays`` of seeded int16
  clips and noise: the assembly and MFCC kernels once each, the res stack
  never.

Each chain is a Python loop of L links (the port launches eagerly, one
kernel at a time, where the reference's scan is one program), fenced once
by ``.item()`` of a scalar that depends on every link. A batch's time is the
median over reps of the marginal ``(t_long - t_short) / (L_long - L_short)``,
after one untimed chain of each length; non-positive marginals are dropped.
So the marginal holds the host's launches too: a link's device time is
read apart (``torch.profiler``, PERF.md).

Prints one JSON line with ``bench.py``'s keys. ``device`` is the card's
name (``cpu`` with ``--device cpu``, which runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

# Dense bf16 peak of an H100 SXM (NVIDIA's data sheet), in place of the
# reference's TPU v5e 197: an implied rate at or past it means work was elided.
PEAK_TFLOPS = 989.0
# Multiply-adds per 1 s utterance x 2 (the reference's table), plus ~47e6 for the frontend.
MODEL_FLOPS = {
    "res8": 124e6, "res8-narrow": 28e6,
    "res15": 1788e6, "res15-narrow": 330e6,
    "res26": 760e6, "res26-narrow": 150e6,
    "cnn-trad-pool2": 190e6,
}
FRONTEND_FLOPS = 47e6


def settings() -> dict:
    """The knobs, from the environment, with the reference's defaults."""
    short = int(os.environ.get("BENCH_SCAN_SHORT", "32"))
    long = int(os.environ.get("BENCH_SCAN_LONG", "160"))
    return {
        "batch": int(os.environ.get("BENCH_BATCH", "256")),
        "scan_lens": (short, long),
        "infer_scan_lens": (2 * short, 2 * long),
        "reps": int(os.environ.get("BENCH_REPS", "7")),
        "model": os.environ.get("BENCH_MODEL", "res8"),
        "dtype": getattr(torch, os.environ.get("BENCH_DTYPE", "bfloat16")),
    }


def make_model(name: str, dtype: torch.dtype, device: torch.device) -> torch.nn.Module:
    from ..models import find_config, find_model, init_weights

    model = find_model(name)(find_config(name), dtype=dtype)
    return init_weights(model, torch.Generator().manual_seed(0)).to(device)


def make_pool(rng: np.random.Generator, batch: int, device: torch.device) -> torch.Tensor:
    """The device-resident audio pool the inference links slide over."""
    pool_n = max(2048, batch * 2)
    return torch.from_numpy((rng.standard_normal((pool_n, 16000)) * 0.1).astype(np.float32)).to(device)


def make_infer_link(model: torch.nn.Module, pool: torch.Tensor, batch: int) -> Callable:
    """``link(i, acc) -> acc``: the reference's inference scan body, link ``i``;
    ``link.logits(i, acc)`` the (B, n_labels) logits it adds up."""
    from ..frontend.mfcc import compute_mfccs

    model.eval()
    with torch.no_grad():
        packed = model.eval_operands()
    pool_n = pool.shape[0]

    @torch.no_grad()
    def logits(i: int, acc: torch.Tensor) -> torch.Tensor:
        start = (i * batch) % (pool_n - batch)
        audio = pool[start:start + batch] + acc * 1e-12
        return model(compute_mfccs(audio), packed=packed)

    def link(i: int, acc: torch.Tensor) -> torch.Tensor:
        return acc + logits(i, acc).sum()

    link.logits = logits
    return link


def make_train_run(model: torch.nn.Module, rng: np.random.Generator, batch: int, pool_n: int,
                   lens: tuple[int, ...], device: torch.device) -> Callable:
    """``run(length, seed) -> seconds``: a chain of ``length`` train steps, fenced by its mean loss."""
    from ..data import AugmentConfig, prepare_train_arrays
    from ..train import create_train_state, make_optimizer, make_train_scan

    aug = AugmentConfig(n_silence=batch // 10)
    audio = rng.integers(-3000, 3000, (pool_n, 16000), dtype=np.int16)
    noise = (rng.standard_normal(16000 * 40) * 0.05).astype(np.float32)
    labels = rng.integers(2, 12, (pool_n,), dtype=np.int32)
    arrays = prepare_train_arrays(audio, labels, noise, aug, device=device)
    tx = make_optimizer()
    state = create_train_state(model, tx)
    scans = {n: make_train_scan(tx, batch, aug, n) for n in lens}

    def run(length: int, seed: float) -> float:
        t0 = time.perf_counter()
        _, m = scans[length](state, int(seed * 1e7), arrays)
        m["loss"].item()
        return time.perf_counter() - t0

    return run


def make_infer_run(link: Callable, device: torch.device) -> Callable:
    """``run(length, seed) -> seconds``: a chain of ``length`` inference links, fenced by ``acc``."""

    def run(length: int, seed: float) -> float:
        t0 = time.perf_counter()
        acc = torch.full((), seed, dtype=torch.float32, device=device)
        for i in range(length):
            acc = link(i, acc)
        acc.item()
        return time.perf_counter() - t0

    return run


def recorded(run: Callable, times: list[float]) -> Callable:
    """``run`` that also appends each chain's seconds to ``times`` in call order:
    under ``marginal``, the untimed chain of each length, then each rep's two."""

    def timed(length: int, seed: float) -> float:
        times.append(run(length, seed))
        return times[-1]

    return timed


#: Called as ``hook("begin" | "end", lens, reps)`` around each ``marginal`` call,
#: one timed leg, untimed chains included: a caller that reads what a leg
#: launched (chip_smoke.py's launch counts) appends here.
LEG_HOOKS: list[Callable[[str, tuple[int, int], int], None]] = []


def marginal(run: Callable, lens: tuple[int, int], reps: int) -> tuple[float, list[float]]:
    """The median marginal seconds per link between chains of ``lens`` links, and each rep's."""
    for hook in LEG_HOOKS:
        hook("begin", lens, reps)
    run(lens[0], 0.0)
    run(lens[1], 0.0)
    ms = []
    for r in range(reps):
        seed = (r + 1) * 1e-6
        ts = run(lens[0], seed)
        tl = run(lens[1], seed)
        m = (tl - ts) / (lens[1] - lens[0])
        if m > 0:
            ms.append(m)
    for hook in LEG_HOOKS:
        hook("end", lens, reps)
    if not ms:
        raise RuntimeError("every marginal timing was non-positive")
    return float(np.median(ms)), ms


def device_name(device: torch.device) -> str:
    """What a tool's line names as its device: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def spread(batch: int, ms: list[float]) -> dict:
    """Per-rep marginal times -> audio-s/s {min, median, max} + raw."""
    aps = sorted(batch / m for m in ms)
    return {
        "min": round(aps[0], 1),
        "median": round(float(np.median(aps)), 1),
        "max": round(aps[-1], 1),
        "n_reps": len(aps),
        "per_rep": [round(a, 1) for a in aps],
    }


def run_bench(knobs: dict, device: torch.device) -> dict:
    """Both marginals and the reference's result record."""
    from .. import use_full_f32

    use_full_f32()
    batch, name = knobs["batch"], knobs["model"]
    rng = np.random.default_rng(0)
    model = make_model(name, knobs["dtype"], device)
    pool = make_pool(rng, batch, device)
    infer_t, infer_ms = marginal(make_infer_run(make_infer_link(model, pool, batch), device),
                                 knobs["infer_scan_lens"], knobs["reps"])
    infer_aps = batch / infer_t
    pool_n = pool.shape[0]
    del pool
    train_t, train_ms = marginal(make_train_run(model, rng, batch, pool_n, knobs["scan_lens"], device),
                                 knobs["scan_lens"], knobs["reps"])
    train_aps = batch / train_t

    fwd_flops = MODEL_FLOPS.get(name, MODEL_FLOPS["res8"]) + FRONTEND_FLOPS
    infer_tflops = infer_aps * fwd_flops / 1e12
    train_tflops = train_aps * 3 * fwd_flops / 1e12
    value = float(np.sqrt(infer_aps * train_aps))
    return {
        "metric": f"audio_seconds_per_s_per_chip_{name.replace('-', '_')}_train_infer_geomean",
        "value": round(value, 1),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(value / 50000.0, 4),
        "infer_audio_s_per_s": round(infer_aps, 1),
        "train_audio_s_per_s": round(train_aps, 1),
        "infer_spread": spread(batch, infer_ms),
        "train_spread": spread(batch, train_ms),
        "batch": batch,
        "scan_lens": list(knobs["scan_lens"]),
        "infer_scan_lens": list(knobs["infer_scan_lens"]),
        "model": name,
        "device": device_name(device),
        "implied_tflops": [round(infer_tflops, 1), round(train_tflops, 1)],
        "suspect": bool(infer_tflops > PEAK_TFLOPS or train_tflops > PEAK_TFLOPS),
    }


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    print(json.dumps(run_bench(settings(), resolve_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
