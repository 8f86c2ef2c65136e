#!/usr/bin/env python3
"""How far apart one and two ranks train, in the port and in the JAX package, on one corpus.

    python scripts/probe_torch_topology_gap.py --hashseed 0 [--seed 0] [--dtypes bfloat16 float32]

Writes the synthetic corpus of ``tests/test_torch_parallel.py`` in a
process with ``PYTHONHASHSEED`` set to ``--hashseed`` (its file names, and
so its splits, follow Python's salted ``hash()``), then runs that test's
resume recipe (``tests/torch_resume.py``: res8-narrow, 4 epochs) for each
dtype:

- the port, through its training CLI on the CPU: 4 epochs on one rank and
  on two; 2 epochs on each resumed for 2 more on each;
- the JAX package (``honk_tpu.train.train``, in this process, with 8
  virtual CPU devices): 4 epochs on one device and on two.

``--full_width`` runs only the JAX package, float32, on chip_smoke.py
phase 10's corpus and recipe at res8's full width (``torch_resume.FULL_CORPUS``
and ``FULL_RECIPE``, the float32 runs of ``scripts/chip_train_nccl.py``):
2 epochs on 1, 2 and 4 devices, and prints the 1-vs-2 and 1-vs-4 gaps.

``--seed`` is the runs' seed, as both training CLIs' ``--seed`` (the
initial weights, the batches and the split's draws; each package draws
its own from it). ``--xla_flags`` adds XLA
flags to the JAX runs alone.

Prints one JSON line: for each pair of runs the largest absolute difference
over every floating-point tensor of the final weights (parameters and BN
statistics); with both dtypes, also each package's bf16 run on one rank
(device) against its float32 run. Imports both packages, as the tests do;
CPU only, about a minute a dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_resume as R  # noqa: E402
from torch_ranks import TIMEOUT, rank_env  # noqa: E402


def probe(hashseed: str, dtypes: list[str], tmp: str, seed: int = 0) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = os.path.join(tmp, "sc")
    R.write_corpus(data, hashseed, rank_env(), TIMEOUT)
    out: dict = {"hashseed": hashseed, "seed": seed, "xla_flags": os.environ["XLA_FLAGS"]}
    finals = {}
    for dtype in dtypes:
        runs = R.resume_runs(data, dtype, pathlib.Path(tmp) / dtype, seed)
        port = {n: R.port_weights(st) for n, st in runs["state"].items()}
        jax_runs = {n: R.jax_weights(data, dtype, n, seed) for n in (1, 2)}
        finals[dtype] = (port["whole1"], jax_runs[1])
        out[dtype] = {
            "port_resume_1_rank": R.max_gap(port["whole1"], port["1to1"]),
            "port_resume_2_ranks": R.max_gap(port["whole2"], port["2to2"]),
            "port_1_vs_2_ranks": R.max_gap(port["whole1"], port["whole2"]),
            "port_1to2_vs_2to1": R.max_gap(port["1to2"], port["2to1"]),
            "jax_1_vs_2_devices": R.max_gap(jax_runs[1], jax_runs[2]),
        }
    if {"bfloat16", "float32"} <= finals.keys():
        (pb, jb), (pf, jf) = finals["bfloat16"], finals["float32"]
        out["bfloat16_vs_float32_one_rank"] = {"port": R.max_gap(pb, pf), "jax": R.max_gap(jb, jf)}
    return out


def probe_full_width(hashseed: str, tmp: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = os.path.join(tmp, "sc")
    R.write_corpus(data, hashseed, rank_env(), TIMEOUT, R.FULL_CORPUS)
    w = {n: R.jax_weights(data, "float32", n, full_width=True) for n in (1, 2, 4)}
    return {"hashseed": hashseed, "jax_1_vs_2_devices": R.max_gap(w[1], w[2]),
            "jax_1_vs_4_devices": R.max_gap(w[1], w[4])}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hashseed", default="0", help="PYTHONHASHSEED of the process that writes the corpus")
    p.add_argument("--seed", type=int, default=0, help="the runs' training seed")
    p.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    p.add_argument("--full_width", action="store_true", help="JAX's float32 gaps at phase 10's full-width recipe")
    p.add_argument("--xla_flags", default="", help="more XLA flags for the JAX runs, e.g. "
                   "--xla_allow_excess_precision=false")
    args = p.parse_args()
    # Before JAX starts; the port's ranks drop XLA_FLAGS (torch_ranks.rank_env).
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count=8 {args.xla_flags}"
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(probe_full_width(args.hashseed, tmp) if args.full_width
                         else probe(args.hashseed, args.dtypes, tmp, args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
