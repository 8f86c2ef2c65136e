#!/usr/bin/env python3
"""The res-stack kernel's two entries against their plain versions on one card, and their times.

    python3 scripts/chip_res_forward.py [--out <file>]

Needs a CUDA device and nvcc; imports nothing of JAX. Prints the card's name
and power limit and each kernel entry's registers and spills, then:

1. the pooled entry (``res_stack``, the TPU kernel's interface) in float32
   against its plain version for res8 (zoo/res8.pt) and random res26,
   res8-narrow and res26-narrow weights at B = 1, 3 and 256 (RES_TOL), and
   its two bf16 modes as ``chip_smoke.py`` phase 29 holds them;
2. the entry from the features with the stem inside (``res_forward``),
   ``chip_smoke.py`` phase 50: every mode against its plain version, one
   device kernel per eval forward, CUDA-event times beside the two-launch
   path it replaced (the stem as PyTorch ops, then the pooled entry).

Prints a JSON summary as the last line (every reading in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="", help="a JSON file for every reading")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_res_forward: no CUDA device is available", file=sys.stderr)
        return 1
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.ops import _build, assemble_kernel, mfcc_kernel, res_kernel

    use_full_f32()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build("mfcc", "res_stack", "assemble")
    out = {"smi": smi, "build_s": time.perf_counter() - t0}
    out["ptxas"] = C.ptxas_summary(logs.get("res_stack", ""))
    for line in out["ptxas"]:
        print(f"[build] res_stack: {line}", flush=True)

    # 1. The pooled entry.
    out["pooled_float32"] = {}
    rng = np.random.default_rng(C.SEED)
    audio = torch.from_numpy((rng.standard_normal((C.BATCH, 16000)) * 0.2).astype(np.float32)).to(dev)
    with torch.inference_mode():
        feats = mfcc_kernel.mfcc(audio)
        for conf, model in C.forward_models(torch, dev).items():
            x, packed = model.stem(feats), res_kernel.pack_res_params(model)
            for b in (1, 3, C.BATCH):
                got = res_kernel.res_stack(x[:b].contiguous(), *packed)
                ref = res_kernel.res_stack_plain(x[:b].contiguous(), *packed)
                torch.cuda.synchronize()
                err = C.max_err(got, ref)
                out["pooled_float32"][f"{conf} B={b}"] = err
                if not torch.isfinite(got).all() or not C.close(got, ref, **C.RES_TOL):
                    C.fail(f"res_stack float32, {conf} B={b}: max abs err {err:.3e}")
    print(f"[pooled float32] {smi}: " + json.dumps(out["pooled_float32"]), flush=True)
    bf16 = C.phase_bf16_kernel(torch, dev, res_kernel, mfcc_kernel, logs, name, smi)
    out["pooled_bf16"] = {k: v for k, v in bf16.items() if k.endswith("times") or k.endswith("err")}

    # 2. The entry from the features.
    counters = {"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel}
    out["res_forward"] = C.phase_res_forward(torch, dev, counters, name, smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"smi": smi, "build_s": out["build_s"], "s": out["res_forward"]["s"],
                      "times": out["res_forward"]["times"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
