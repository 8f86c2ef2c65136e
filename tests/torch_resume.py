"""The checkpoint-resume recipe of ``tests/test_torch_parallel.py``, shared with ``scripts/probe_torch_topology_gap.py``.

res8-narrow on the synthetic corpus (6 clips per word, 3 speakers, 3 s of
noise), batch 16, lr 0.01, 4 epochs in all: the port through its training
CLI on 1 or 2 gloo ranks (``scripts/chip_train_nccl.py``: 1, 2 and 4 NCCL
ranks on the card), the JAX package through ``honk_tpu.train.train``
on 1 or 2 of the 8 virtual CPU devices. A run's weights are compared by the
largest absolute difference over every floating-point tensor.
"""

import contextlib
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

from torch_ranks import run_ranks

EPOCHS = 4
# Twice the largest JAX 1-vs-2-device gap of the recipe, float32, over the
# corpora of hash seeds 0-4 (scripts/probe_torch_topology_gap.py).
TOPOLOGY_GAP_F32 = 2 * 3.8933753967285156e-3
# The JAX package's bf16 1-vs-2-device gap of the recipe on the corpus of each
# hash seed, training seed 0 (scripts/probe_torch_topology_gap.py, on the CPU
# with 8 virtual devices; ROADMAP.md §3.2).
JAX_BF16_GAP = {"0": 0.0083, "1": 0.0054, "2": 0.024, "3": 0.0081, "4": 0.031}
PORT_RECIPE = ["--model", "res8-narrow", "--batch_size", "16", "--lr", "0.01", "--schedule", "--dev_every", "2",
               "--eval_batch_size", "32", "--noise_prob", "0.1", "--steps_per_call", "4"]


# chip_smoke.py phase 10's corpus and recipe (the CLI's defaults otherwise: lr
# 0.1 / 0.01 / 0.001), at res8's full width: scripts/chip_train_nccl.py's float32 runs.
FULL_CORPUS = {"clips_per_word": 40, "n_speakers": 8}
FULL_RECIPE = {"model": "res8", "batch_size": 64, "n_epochs": 2, "dev_every": 1}
# Twice the largest of the JAX package's own gaps between 1 device and 2 or 4
# devices at FULL_RECIPE in float32, over FULL_CORPUS written under hash seeds
# 0-4 (scripts/probe_torch_topology_gap.py --full_width, on the CPU with 8
# virtual devices). At lr 0.1 the reassociated sums grow within two epochs
# into differences of the BN running variances' size (about 20).
TOPOLOGY_GAP_FULL_F32 = 2 * 1.8897861242294312


def write_corpus(data_dir: str, hashseed: str, env: dict, timeout: float, sizes: dict | None = None) -> None:
    """The corpus (``sizes``: generate_dataset's; the recipe's by default), written in a process with
    ``PYTHONHASHSEED=hashseed``: the generator names its files with Python's salted ``hash()``, and the
    names decide the splits."""
    sizes = sizes or {"clips_per_word": 6, "n_speakers": 3, "noise_seconds": 3}
    subprocess.run([sys.executable, "-c", "from honk_tpu_torch.data import generate_dataset; "
                    f"generate_dataset({data_dir!r}, **{sizes!r})"],
                   env=dict(env, PYTHONHASHSEED=hashseed), check=True, timeout=timeout)


def port_cli(data_dir: str, dtype: str, out_dir: str, epochs: int, ranks: int, save_every: int | None = None,
             seed: int = 0, device: str = "cpu") -> list:
    """The port's training CLI on ``device`` (``cuda``: NCCL ranks, rank r on card r): ``epochs`` in all
    into ``out_dir`` (resuming what it holds); ``seed`` draws the initial weights and the batches."""
    cmd = [sys.executable, "-m", "honk_tpu_torch.cli.train", "--device", device, *PORT_RECIPE, "--data_dir", data_dir,
           "--compute_dtype", dtype, "--n_epochs", str(epochs), "--output_dir", out_dir, "--seed", str(seed)]
    cmd += ["--n_devices", str(ranks)] if ranks > 1 else []
    return cmd + (["--save_every_epochs", str(save_every)] if save_every else [])


def resume_runs(data: str, dtype: str, tmp: pathlib.Path, seed: int = 0) -> dict:
    """The recipe in ``dtype``: 4 epochs uninterrupted on 1 and on 2 ranks (``whole1``,
    ``whole2``), and 2 epochs on each resumed on each for 2 more (``1to1``, ``1to2``, ``2to1``, ``2to2``)."""
    d = {}

    def out(name):
        return d.setdefault(name, str(tmp / name))

    half = EPOCHS // 2
    first = {"whole1": (EPOCHS, 1), "whole2": (EPOCHS, 2), "half1": (half, 1, 1), "half2": (half, 2, 1)}
    logs = dict(zip(first, run_ranks([port_cli(data, dtype, out(n), *a, seed=seed) for n, a in first.items()])))
    resumes = ["1to1", "1to2", "2to1", "2to2"]
    for n in resumes:
        shutil.copytree(out(f"half{n[0]}"), out(n))
    logs.update(zip(resumes, run_ranks([port_cli(data, dtype, out(n), EPOCHS, int(n[-1]), seed=seed)
                                        for n in resumes])))
    # Each rank's log; the state and whether best.pt is there, by run.
    return {"logs": logs, "state": {n: latest(p) for n, p in d.items()},
            "best": {n: os.path.isfile(os.path.join(p, "best.pt")) for n, p in d.items()}}


def latest(out_dir: str) -> dict:
    """The newest step checkpoint's training state: ``step``, ``model`` and ``optimizer``."""
    import torch

    name = max(f for f in os.listdir(out_dir) if f.startswith("step_"))
    return torch.load(os.path.join(out_dir, name), weights_only=True)["state"]


def flat_tensors(state: dict) -> dict:
    """Every tensor of a training state (the model's and the optimizer's), by path."""
    import torch

    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            out[prefix] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)

    walk("", {k: state[k] for k in ("model", "optimizer")})
    return out


def max_gap(a: dict, b: dict) -> float:
    """The largest absolute difference over every floating-point tensor of two sets of weights."""
    return max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max())
               for k in a if np.issubdtype(np.asarray(a[k]).dtype, np.floating))


def port_weights(state: dict) -> dict:
    return {k: v.numpy() for k, v in state["model"].items()}


def jax_weights(data_dir: str, dtype: str, n_devices: int, seed: int = 0, full_width: bool = False) -> dict:
    """The JAX package's weights after the recipe's 4 epochs (``full_width``: FULL_RECIPE) on ``n_devices``
    of the virtual CPU devices."""
    import jax

    from honk_tpu.config import DataConfig, ExperimentConfig, MeshConfig, TrainConfig
    from honk_tpu.metrics import MetricsLogger
    from honk_tpu.train import train

    if full_width:
        data = DataConfig(data_dir=data_dir, seed=seed)
        train_cfg = TrainConfig(**FULL_RECIPE, compute_dtype=dtype, seed=seed)
    else:
        data = DataConfig(data_dir=data_dir, noise_prob=0.1, seed=seed)  # the CLI's --seed sets both seeds
        train_cfg = TrainConfig(model="res8-narrow", batch_size=16, n_epochs=EPOCHS, lr=(0.01,), schedule=(),
                                dev_every=2, eval_batch_size=32, steps_per_call=4, compute_dtype=dtype, seed=seed)
    cfg = ExperimentConfig(data=data, train=train_cfg, mesh=MeshConfig(n_devices=n_devices))
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        st = train(cfg, logger=MetricsLogger(stream=sink))["state"]
    return {jax.tree_util.keystr(k): np.asarray(v) for part in (st.params, st.batch_stats)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(part))[0]}
