"""The checkpoint-resume recipe of ``tests/test_torch_parallel.py``, shared with ``scripts/probe_torch_topology_gap.py``.

res8-narrow on the synthetic corpus (6 clips per word, 3 speakers, 3 s of
noise), batch 16, lr 0.01, 4 epochs in all: the port through its training
CLI on 1 or 2 gloo ranks, the JAX package through ``honk_tpu.train.train``
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
PORT_RECIPE = ["--model", "res8-narrow", "--batch_size", "16", "--lr", "0.01", "--schedule", "--dev_every", "2",
               "--eval_batch_size", "32", "--noise_prob", "0.1", "--steps_per_call", "4"]


def write_corpus(data_dir: str, hashseed: str, env: dict, timeout: float) -> None:
    """The corpus, written in a process with ``PYTHONHASHSEED=hashseed``: the
    generator names its files with Python's salted ``hash()``, and the names
    decide the splits."""
    subprocess.run([sys.executable, "-c", "from honk_tpu_torch.data import generate_dataset; "
                    f"generate_dataset({data_dir!r}, clips_per_word=6, n_speakers=3, noise_seconds=3)"],
                   env=dict(env, PYTHONHASHSEED=hashseed), check=True, timeout=timeout)


def port_cli(data_dir: str, dtype: str, out_dir: str, epochs: int, ranks: int, save_every: int | None = None) -> list:
    """The port's training CLI on the CPU: ``epochs`` in all into ``out_dir`` (resuming what it holds)."""
    cmd = [sys.executable, "-m", "honk_tpu_torch.cli.train", "--device", "cpu", *PORT_RECIPE, "--data_dir", data_dir,
           "--compute_dtype", dtype, "--n_epochs", str(epochs), "--output_dir", out_dir]
    cmd += ["--n_devices", str(ranks)] if ranks > 1 else []
    return cmd + (["--save_every_epochs", str(save_every)] if save_every else [])


def resume_runs(data: str, dtype: str, tmp: pathlib.Path) -> dict:
    """The recipe in ``dtype``: 4 epochs uninterrupted on 1 and on 2 ranks (``whole1``,
    ``whole2``), and 2 epochs on each resumed on each for 2 more (``1to1``, ``1to2``, ``2to1``, ``2to2``)."""
    d = {}

    def out(name):
        return d.setdefault(name, str(tmp / name))

    half = EPOCHS // 2
    first = {"whole1": (EPOCHS, 1), "whole2": (EPOCHS, 2), "half1": (half, 1, 1), "half2": (half, 2, 1)}
    logs = dict(zip(first, run_ranks([port_cli(data, dtype, out(n), *a) for n, a in first.items()])))
    resumes = ["1to1", "1to2", "2to1", "2to2"]
    for n in resumes:
        shutil.copytree(out(f"half{n[0]}"), out(n))
    logs.update(zip(resumes, run_ranks([port_cli(data, dtype, out(n), EPOCHS, int(n[-1])) for n in resumes])))
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


def jax_weights(data_dir: str, dtype: str, n_devices: int) -> dict:
    """The JAX package's weights after the recipe's 4 epochs on ``n_devices`` of the virtual CPU devices."""
    import jax

    from honk_tpu.config import DataConfig, ExperimentConfig, MeshConfig, TrainConfig
    from honk_tpu.metrics import MetricsLogger
    from honk_tpu.train import train

    cfg = ExperimentConfig(
        data=DataConfig(data_dir=data_dir, noise_prob=0.1),
        train=TrainConfig(model="res8-narrow", batch_size=16, n_epochs=EPOCHS, lr=(0.01,), schedule=(), dev_every=2,
                          eval_batch_size=32, steps_per_call=4, compute_dtype=dtype),
        mesh=MeshConfig(n_devices=n_devices))
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        st = train(cfg, logger=MetricsLogger(stream=sink))["state"]
    return {jax.tree_util.keystr(k): np.asarray(v) for part in (st.params, st.batch_stats)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(part))[0]}
