#!/usr/bin/env python3
"""The recipe's accuracy on the card for more training seeds (chip_smoke.py phase 34's run).

    python3 scripts/chip_recipe.py --seeds 1 2 [--compute_dtype float32]

Regenerates the hard_v2 corpus from zoo_hard_v2/MANIFEST.json's
corpus_recipe, then for each seed trains res8 and res15 through ``python -m
honk_tpu_torch.cli.zoo build`` at zoo_hard_v2's recipe (``--compute_dtype``
overrides its bf16) and scores them with ``cli.zoo compare --against
zoo_hard_v2``, with chip_smoke.py's launch counts. It reports each model's
accuracies against the JAX package's seeds 0-2 widened by 2 SE, and res15's
McNemar z over res8, without a gate; one JSON line a seed, then a summary.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--compute_dtype", choices=["bfloat16", "float32"], default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_recipe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from honk_tpu_torch.ops import assemble_kernel, mfcc_kernel, res_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    counters = {"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "hard_v2")
        print(f"[recipe] hard_v2 corpus generated in {C.hard_v2_corpus(root):.1f} s")
        for seed in args.seeds:
            t0 = time.perf_counter()
            out = C.phase_recipe(torch, counters, root, tmp, smi, seed, args.compute_dtype, gate=False)
            out["wall_s"] = time.perf_counter() - t0
            runs.append(out)
    print(json.dumps({"device": smi, "summary": [
        {"seed": r["seed"], "compute_dtype": r["compute_dtype"], "z_res15_over_res8": r["z_res15_over_res8"],
         **{f"{m}_{k}": v[k] for m, v in r["models"].items() for k in ("test_acc", "test_acc_recheck", "in_range")},
         **{f"{m}_z_against_jax": v["against"]["mcnemar_z"] for m, v in r["models"].items()}} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
