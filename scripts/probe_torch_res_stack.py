#!/usr/bin/env python3
"""Probe the port's res-stack kernel on one NVIDIA GPU: its launch geometry and accuracy.

    python3 scripts/probe_torch_res_stack.py [--modes float32 bfloat16 bfloat16_activations]
        [--entries forward pooled] [--batches 1 8 256 2996] [--out <file>]

For res8 (zoo/res8.pt), res26 and res8-narrow (random weights from a seed),
in each mode and through each entry (``forward``: ``res_forward`` from the
features, the stem inside; ``pooled``: ``res_stack`` from the pooled map),
at each batch size, times the kernel (CUDA events over back-to-back calls
queued behind a spin kernel, as chip_smoke.py does) at every cluster size
whose bands fit and, in the bf16 modes, at every split of N the kernel
takes (``n_parts``; 0 is the kernel's own cost), and prints beside them
the geometry the wrapper and the kernel pick (``cluster_size``, then
``n_parts=0``), the fastest one, and each launch's max abs error
against the plain version of the same mode. Prints the card's name and
power limit first, each kernel entry's registers and spills if it builds
the kernel now, a JSON line per case, and a JSON summary last (every
reading in ``--out``). Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 400_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--modes", nargs="+", default=["float32", "bfloat16", "bfloat16_activations"],
                    choices=["float32", "bfloat16", "bfloat16_activations"])
    ap.add_argument("--entries", nargs="+", default=["forward", "pooled"], choices=["forward", "pooled"])
    ap.add_argument("--batches", nargs="+", type=int, default=[1, 8, 256, 2996])
    ap.add_argument("--out", default="", help="a JSON file for every reading")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("probe_torch_res_stack: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.models import SpeechResModel, find_config, load_honk_checkpoint
    from honk_tpu_torch.ops import _build, mfcc_kernel, res_kernel as R

    use_full_f32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    for line in _build.build("mfcc", "res_stack").get("res_stack", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    dtypes = {"float32": (torch.float32, torch.float32), "bfloat16": (torch.bfloat16, torch.float32),
              "bfloat16_activations": (torch.bfloat16, torch.bfloat16)}
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((max(args.batches), 16000)) * 0.2).astype(np.float32)).to(dev)
    feats = mfcc_kernel.mfcc(audio)
    del audio
    res8 = load_honk_checkpoint(os.path.join(ROOT, "zoo", "res8.pt"), SpeechResModel(find_config("res8")))
    torch.manual_seed(0)
    models = {"res8": res8, "res26": SpeechResModel(find_config("res26")),
              "res8-narrow": SpeechResModel(find_config("res8-narrow"))}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    with torch.inference_mode():
        for conf, model in models.items():
            model = model.to(dev).eval()
            w0, pool = model.conv0.weight, tuple(model.pool)
            for mode in args.modes:
                compute, act = dtypes[mode]
                packed = R.pack_res_params(model, compute, act)
                kw = dict(compute_dtype=compute, activation_dtype=act)
                pooled = model.stem(feats, torch.bfloat16 if mode == "bfloat16_activations" else torch.float32)
                C, H, W = pooled.shape[1:]
                for entry in args.entries:
                    for b in args.batches:
                        f, x = feats[:b].contiguous(), pooled[:b].contiguous()
                        if entry == "forward":
                            ref = R.res_forward_plain(f, w0, pool, *packed, **kw)
                            call = lambda cs, p: R._launch(f, *packed, **kw, cluster=cs, conv0_w=w0, pool=pool,
                                                           n_parts=p)
                        else:
                            ref = R.res_stack_plain(x, *packed, **kw)
                            call = lambda cs, p: R._launch(x, *packed, **kw, cluster=cs, n_parts=p)
                        iters = 50 if b <= 8 else 10 if b <= 256 else 3
                        readings = {}
                        for cs in (1, 2, 4, 8):
                            if not R.fits(C, H, W, cs, compute, act) or (entry == "forward" and (
                                    (-(-H // cs) + 2) * pool[0] + 2) * 42 * 4 > R._layout(C, H, W, cs, mode)["act"]):
                                continue
                            nt = -(-C // 8)
                            for p in [0] + ([] if mode == "float32" else [q for q in (1, 2, 3, 4) if nt % q == 0]):
                                got = call(cs, p)
                                torch.cuda.synchronize()
                                readings[f"cs={cs} parts={p}"] = {
                                    "ms": time_ms(torch, lambda: call(cs, p), iters),
                                    "max_abs_err_vs_plain": float((got - ref).abs().max()),
                                    "argmax_equal_plain": float((got.argmax(-1) == ref.argmax(-1)).float().mean())}
                        chosen = f"cs={R.cluster_size(b, C, H, W, n_sm, compute, act)} parts=0"
                        best = min(readings, key=lambda k: readings[k]["ms"])
                        row = {"model": conf, "mode": mode, "entry": entry, "batch": b, "picked": chosen,
                               "picked_ms": readings[chosen]["ms"], "fastest": best,
                               "fastest_ms": readings[best]["ms"],
                               "picked_over_fastest": readings[chosen]["ms"] / readings[best]["ms"],
                               "readings": readings}
                        rows.append(row)
                        print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    worst = max(rows, key=lambda r: r["picked_over_fastest"])
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"smi": smi, "rows": rows}, fh, indent=1)
    print(json.dumps({"smi": smi, "cases": len(rows),
                      "picked_is_fastest": sum(r["picked"] == r["fastest"] for r in rows),
                      "worst": {k: worst[k] for k in ("model", "mode", "entry", "batch", "picked", "picked_ms",
                                                      "fastest", "fastest_ms", "picked_over_fastest")},
                      "max_abs_err_vs_plain": {m: max(v["max_abs_err_vs_plain"] for r in rows if r["mode"] == m
                                                      for v in r["readings"].values()) for m in args.modes}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
