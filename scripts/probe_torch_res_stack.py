#!/usr/bin/env python3
"""Probe the port's res-stack kernel on one NVIDIA GPU: cluster sizes and accuracy.

    python3 scripts/probe_torch_res_stack.py [--modes float32 bfloat16]

For res8 (zoo/res8.pt), res8-narrow and res26 (random weights from a seed)
at several batch sizes, in each operand mode (float32: 3xTF32; bfloat16:
bf16 operands), times the kernel (CUDA events over back-to-back calls
queued behind a spin kernel, as chip_smoke.py does) at every cluster size
whose bands fit, next to the one the wrapper picks, and prints the max abs
error of the kernel and of the float32 plain version against the plain
version of the same mode in float64 (in the bf16 mode its operands rounded
to bf16 as the kernel rounds them). Prints the card's name and power limit
first, and each kernel entry's registers and spills if it builds the
kernel now. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

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
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="+", default=["float32", "bfloat16"], choices=["float32", "bfloat16"])
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
    print(f"nvidia-smi: {smi}")
    for line in _build.build("res_stack").get("res_stack", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    modes = [getattr(torch, m) for m in args.modes]
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((256, 16000)) * 0.2).astype(np.float32)).to(dev)
    feats = mfcc_kernel.mfcc_plain(audio)
    res8 = load_honk_checkpoint(os.path.join(ROOT, "zoo", "res8.pt"), SpeechResModel(find_config("res8")))
    torch.manual_seed(0)
    res26 = SpeechResModel(find_config("res26"))
    narrow = SpeechResModel(find_config("res8-narrow"))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        for conf, model, batches in (("res8", res8, (1, 64, 133, 256)), ("res8-narrow", narrow, (1, 256)),
                                     ("res26", res26, (1, 256))):
            model = model.to(dev).eval()
            pooled = model.stem(feats)
            C, H, W = pooled.shape[1:]
            for dtype in modes:
                packed = R.pack_res_params(model, dtype)
                for b in batches:
                    x = pooled[:b].contiguous()
                    ref64 = R.res_stack_plain(x.double(), *(p.double() for p in packed), compute_dtype=dtype)
                    plain = R.res_stack_plain(x, *packed, compute_dtype=dtype)
                    plain_err = float((plain.double() - ref64).abs().max())
                    iters = 50 if b <= 64 else 10
                    by_cluster = {}
                    for cs in (1, 2, 4, 8):
                        tiles = -(-(-(-H // cs) * W) // 16)
                        if cs > H or tiles > R.MAX_TILES or R.smem_bytes(C, H, W, cs, dtype) > R.SMEM_LIMIT:
                            continue
                        got = R._launch(x, *packed, compute_dtype=dtype, cluster=cs)
                        torch.cuda.synchronize()
                        by_cluster[cs] = {
                            "ms": time_ms(torch, lambda: R._launch(x, *packed, compute_dtype=dtype, cluster=cs), iters),
                            "max_abs_err_vs_f64": float((got.double() - ref64).abs().max()),
                            "max_abs_err_vs_plain": float((got - plain).abs().max()),
                            "argmax_equal_plain": float((got.argmax(-1) == plain.argmax(-1)).float().mean()),
                        }
                    print(json.dumps({"model": conf, "mode": R.MODES[(dtype, torch.float32)], "batch": b,
                                      "wrapper_cluster": R.cluster_size(b, C, H, W, n_sm, dtype),
                                      "by_cluster": by_cluster, "plain_f32_max_abs_err_vs_f64": plain_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
