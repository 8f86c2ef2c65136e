#!/usr/bin/env python3
"""The reference's kernel-against-library tools at full length on one card, each leg beside its device time.

    python3 scripts/chip_profile_tools.py [--smoke] [--sections ...] [--out <file>]

Needs a CUDA device. Builds the three kernels, then (every reading printed
with the card's name and power limit):

1. ``python -m honk_tpu_torch.cli.bench_res_kernel`` (``scripts/bench_res_kernel.py``)
   at ``RK_BATCH`` 1, 8, 256, 1,024 and 2,996 for ``RK_MODEL`` res8 and
   res26 (bf16, ``RK_REPS`` 3, chains of 8 and 32): its two lines; then
   each leg (``model``, ``xla``, ``fused``) under ``torch.profiler`` over
   20 links: device ms and kernels a link.
2. ``cli.microbench`` (``scripts/tpu_microbench.py``) at B=256 and 1,024
   (float32 res8, chains of 100 and 300): its four lines; the profiler over
   each leg's links.
3. ``cli.prof_fwd`` (``prof_fwd2.py``), every leg at B=1,024.
4. ``cli.prof_train`` (``prof_train.py``), every leg at B=256.
5. ``cli.prof_res15``, ``cli.prof_res15_parts``, ``cli.prof_res15_dispatch``
   at their defaults (B=256, 5 reps, chains of 8 and 40).
6. Each kernel against its library leg on the device alone (CUDA events
   behind a spin kernel, ``chip_smoke.time_ms``) at B = 1, 8, 256, 1,024 and
   2,996: the MFCC kernel against ``mfcc_plain`` (cuBLAS DFT GEMMs); a
   res8's float32 eval forward (stem, then the res stack's float32 mode)
   against ``_folded_stack`` in float32 (cuDNN); res8's and res26's bf16
   forwards: ``res_forward_fused`` (the ``bfloat16`` mode) and the model's
   own (``bfloat16_activations``) against ``_folded_stack`` in bf16. Where
   a leg is host-bound (small B), the events time the host's enqueueing.
7. ``torch.profiler`` over 10 links of each ``prof_train`` leg and of
   ``cli.bench``'s train link in the same process: device ms, kernels and
   idle share a link.
8. The profiler over the float32 res8 forward's two legs at B=256 and
   1,024: the kernel path and cuDNN's.
9. A stronger library leg than the tools' eager NCHW one, timed here and
   run nowhere in the port: the same ``_folded_stack`` eager in
   channels_last, and under ``torch.compile`` (Inductor fuses the BN fold,
   ReLU, residual adds and pool into Triton kernels around cuDNN's convs,
   as XLA fuses the reference's flax apply) in NCHW and channels_last,
   beside the kernel's legs, for float32 res8 and bf16 res8 / res26 at B =
   256, 1,024 and 2,996 (CUDA events; each compiled leg's first call,
   its compile, timed apart and its logits held to the eager leg's).

``--sections`` picks among ``rk micro fwd train res15 events
train_profile f32_profile fused`` (all by default). ``--smoke`` runs
chip_smoke.py's phases 40-48 alone first (the tools at short knobs,
launches counted per leg). Prints a JSON summary as the last
line (every reading in ``--out``, where given); exits 1 if a reading fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402

RK_BATCHES = (1, 8, 256, 1024, 2996)
EVENT_BATCHES = (1, 8, 256, 1024, 2996)


def profile_legs(torch, legs: dict, make_link, n: int = 20) -> dict:
    """Device ms and kernels a link of each leg (``make_link(fn)`` -> ``link(i, acc)``)."""
    out = {}
    for leg, fn in legs.items():
        link = make_link(fn)
        acc = [torch.zeros((), device="cuda")]
        i = [0]

        def step():
            acc[0] = link(i[0], acc[0])
            i[0] += 1

        for _ in range(3):
            step()
        out[leg] = C.profile_steps(torch, step, n)
    return out


def event_times(torch, smi: str) -> dict:
    """Kernel against library leg, device ms by CUDA events, at each batch."""
    from honk_tpu_torch.cli import bench, bench_res_kernel
    from honk_tpu_torch.frontend.mfcc import compute_mfccs
    from honk_tpu_torch.ops.mfcc_kernel import mfcc_plain
    from honk_tpu_torch.ops.res_kernel import fold_bn

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((max(EVENT_BATCHES), 16000)) * 0.1).astype(np.float32)).to(dev)
    feats = torch.from_numpy((rng.standard_normal((max(EVENT_BATCHES), 101, 40)) * 2).astype(np.float32)).to(dev)
    f32 = bench.make_model("res8", torch.float32, dev).eval()
    with torch.no_grad():
        f32_ops, f32_fold = f32.eval_operands(), fold_bn(f32)
    forwards = {conf: bench_res_kernel.make_forwards(bench.make_model(conf, torch.bfloat16, dev))
                for conf in ("res8", "res26")}
    out = {}
    with torch.no_grad():
        for b in EVENT_BATCHES:
            a, f = audio[:b].contiguous(), feats[:b].contiguous()
            iters = 200 if b <= 8 else 20
            row = {
                "mfcc_kernel": C.time_ms(torch, lambda: compute_mfccs(a), iters),
                "mfcc_plain": C.time_ms(torch, lambda: mfcc_plain(a), iters),
                "res8_f32_kernel_path": C.time_ms(torch, lambda: f32(f, packed=f32_ops), iters),
                "res8_f32_cudnn": C.time_ms(torch, lambda: f32._folded_stack(f, torch.float32, *f32_fold), iters),
            }
            for conf, legs in forwards.items():
                for leg, fn in legs.items():
                    row[f"{conf}_bf16_{leg}"] = C.time_ms(torch, lambda: fn(f), iters)
            out[str(b)] = row
            print(f"[events B={b}] {smi}: " + json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return out


def train_profiles(torch) -> dict:
    """Device ms, kernels and idle share a link of each prof_train leg (bf16 res8, B=256), and of
    cli.bench's train link (one make_train_scan step) beside them in the same process."""
    from honk_tpu_torch.cli import bench, prof_train

    dev = torch.device("cuda")
    out = {}
    for leg in prof_train.LEGS:
        kind, fn = prof_train.make_leg(leg, prof_train.make_setup("res8", torch.bfloat16, 256, dev))
        if kind == "state":
            step = fn
        else:
            acc, i = [torch.zeros((), device=dev)], [0]

            def step(fn=fn, acc=acc, i=i):
                acc[0] = fn(i[0], acc[0])
                i[0] += 1

        for _ in range(3):
            step()
        out[leg] = C.profile_steps(torch, step, 10)
        torch.cuda.empty_cache()
    run = bench.make_train_run(bench.make_model("res8", torch.bfloat16, dev), np.random.default_rng(0), 256, 2048,
                               (1,), dev)
    for _ in range(3):
        run(1, 0.0)
    out["cli.bench train link"] = C.profile_steps(torch, lambda: run(1, 0.0), 10)
    return out


def f32_profiles(torch) -> dict:
    """Device ms and kernels of a float32 res8's eval forward: the kernel path against cuDNN's."""
    from honk_tpu_torch.cli import bench, bench_res_kernel
    from honk_tpu_torch.ops.res_kernel import fold_bn

    dev = torch.device("cuda")
    model = bench.make_model("res8", torch.float32, dev).eval()
    with torch.no_grad():
        ops, fold = model.eval_operands(), fold_bn(model)
    legs = {"kernel_path": lambda f: model(f, packed=ops),
            "cudnn": lambda f: model._folded_stack(f, torch.float32, *fold)}
    out = {}
    for b in (256, 1024):
        pool = bench_res_kernel.make_pool(b, dev)
        out[str(b)] = profile_legs(torch, legs, lambda fn: bench_res_kernel.make_link(fn, pool, b))
    return out


FUSED_BATCHES = (256, 1024, 2996)


def fused_library_times(torch, smi) -> dict:
    """Section 9: each res-stack forward's kernel legs beside its library leg eager
    (NCHW, channels_last) and compiled by Inductor (NCHW, channels_last)."""
    import copy

    from honk_tpu_torch.cli import bench
    from honk_tpu_torch.ops.res_kernel import fold_bn, pack_res_params, res_forward_fused

    import torch._dynamo

    # One code object serves every compiled leg: past dynamo's recompile limit
    # (8) a call would run eager unannounced, so the limit is raised, hitting it
    # raises, and the caches are cleared for each model.
    cfg = torch._dynamo.config
    for name, value in (("recompile_limit", 64), ("cache_size_limit", 64), ("fail_on_recompile_limit_hit", True)):
        if hasattr(cfg, name):
            setattr(cfg, name, value)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    feats = torch.from_numpy((rng.standard_normal((max(FUSED_BATCHES), 101, 40)) * 2).astype(np.float32)).to(dev)
    out = {}
    for conf, dtype in (("res8", torch.float32), ("res8", torch.bfloat16), ("res26", torch.bfloat16)):
        torch._dynamo.reset()
        model = bench.make_model(conf, dtype, dev).eval()
        cl = copy.deepcopy(model).to(memory_format=torch.channels_last)
        with torch.no_grad():
            own, fold = model.eval_operands(), fold_bn(model)
            legs = {"kernel_path": lambda f, m=model, p=own: m(f, packed=p)}
            if dtype == torch.bfloat16:
                legs["fused"] = lambda f, m=model, p=pack_res_params(model, dtype): res_forward_fused(m, f, packed=p)
        for name, m in (("nchw", model), ("channels_last", cl)):
            legs[f"library_eager_{name}"] = lambda f, m=m: m._folded_stack(f, dtype, *fold)
            legs[f"library_compiled_{name}"] = torch.compile(legs[f"library_eager_{name}"], dynamic=False)
        key = f"{conf} {str(dtype).removeprefix('torch.')}"
        out[key] = {}
        for b in FUSED_BATCHES:
            f = feats[:b].contiguous()
            row = {}
            with torch.no_grad():
                eager = legs["library_eager_nchw"](f).float()
                for leg, fn in legs.items():
                    try:
                        t0 = time.perf_counter()
                        got = fn(f).float()
                        torch.cuda.synchronize()
                        if leg.startswith("library_compiled"):
                            row[f"{leg}_first_call_s"] = time.perf_counter() - t0
                        row[f"{leg}_max_abs_diff_eager"] = float((got - eager).abs().max())
                        row[leg] = C.time_ms(torch, lambda: fn(f), 20)
                    except Exception as e:  # noqa: BLE001 - recorded; the other legs run
                        row[leg] = None
                        row[f"{leg}_error"] = f"{type(e).__name__}: {str(e)[:400]}"
            out[key][str(b)] = row
            print(f"[fused {key} B={b}] {smi}: " + json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return out


SECTIONS = ("rk", "micro", "fwd", "train", "res15", "events", "train_profile", "f32_profile", "fused")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true", help="chip_smoke.py's phases 40-48 first")
    p.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS))
    p.add_argument("--out", default="", help="a JSON file for every reading")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_profile_tools: no CUDA device is available", file=sys.stderr)
        return 1
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.cli import (bench, bench_res_kernel, microbench, prof_fwd, prof_res15, prof_res15_dispatch,
                                    prof_res15_parts, prof_train)
    from honk_tpu_torch.ops import _build, assemble_kernel, mfcc_kernel, res_kernel

    use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {os.cpu_count()} host cores", flush=True)
    t0 = time.perf_counter()
    _build.build("mfcc", "res_stack", "assemble")
    out = {"smi": smi, "host_cores": os.cpu_count(), "build_s": time.perf_counter() - t0, "failed": []}
    dev = torch.device("cuda")

    def guarded(what: str, fn):
        t1 = time.perf_counter()
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 - recorded, and the next reading runs
            out["failed"].append(f"{what}: {type(e).__name__}: {e}")
            print(f"[{what}] FAILED: {traceback.format_exc()[-3000:]}", flush=True)
            result = None
        torch.cuda.empty_cache()
        print(f"[{what}] {smi}: {time.perf_counter() - t1:.1f} s", flush=True)
        return result

    def tool(argv_main, argv, env=None) -> list[str]:
        with mock.patch.dict(os.environ, env or {}):
            rc, text = C.run_cli(argv_main, argv)
        if rc != 0:
            raise RuntimeError(f"returned {rc}: {text[-1500:]}")
        for line in text.splitlines():
            print(f"  {smi}: {line}", flush=True)
        return text.splitlines()

    if args.smoke:
        counters = {"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel}
        with tempfile.TemporaryDirectory() as tmp:
            out["smoke"] = guarded("smoke phases 40-48", lambda: C.phase_profile_tools(torch, counters, tmp, smi))

    def rk_reading(conf: str, batch: int) -> dict:
        lines = tool(bench_res_kernel.main, [], {"RK_MODEL": conf, "RK_BATCH": str(batch)})
        model = bench.make_model(conf, torch.bfloat16, dev)
        pool = bench_res_kernel.make_pool(batch, dev)
        prof = profile_legs(torch, bench_res_kernel.make_forwards(model),
                            lambda fn: bench_res_kernel.make_link(fn, pool, batch))
        return {"model_line": lines[0], "model_ms": float(lines[0].split()[1]), "row": json.loads(lines[1]),
                "device_ms": {leg: r["device_ms"] for leg, r in prof.items()}, "profile": prof}

    if "rk" in args.sections:
        out["bench_res_kernel"] = {f"{conf} B={b}": guarded(f"bench_res_kernel {conf} B={b}",
                                                            lambda conf=conf, b=b: rk_reading(conf, b))
                                   for conf in ("res8", "res26") for b in RK_BATCHES}

    def micro_reading(batch: int) -> dict:
        lines = tool(microbench.main, [str(batch)])
        audio, feats = microbench.make_inputs(batch, dev)
        legs = microbench.make_legs(bench.make_model("res8", torch.float32, dev), "res8", audio, feats)
        prof = profile_legs(torch, legs, lambda fx: microbench.make_link(*fx))
        ms = {line.split(":")[0].strip(): float(line.split(":")[1].split()[0]) for line in lines}
        return {"ms": ms, "device_ms": {leg: r["device_ms"] for leg, r in prof.items()}, "profile": prof}

    if "micro" in args.sections:
        out["microbench"] = {str(b): guarded(f"microbench B={b}", lambda b=b: micro_reading(b)) for b in (256, 1024)}
    if "fwd" in args.sections:
        out["prof_fwd"] = {leg: guarded(f"prof_fwd {leg}", lambda leg=leg: tool(prof_fwd.main, [leg]))
                           for leg in prof_fwd.LEGS}
    if "train" in args.sections:
        out["prof_train"] = {leg: guarded(f"prof_train {leg}", lambda leg=leg: tool(prof_train.main, [leg]))
                             for leg in prof_train.LEGS}
    if "res15" in args.sections:
        for name, mod in (("prof_res15", prof_res15), ("prof_res15_parts", prof_res15_parts),
                          ("prof_res15_dispatch", prof_res15_dispatch)):
            out[name] = guarded(name, lambda mod=mod: json.loads(tool(mod.main, [])[-1]))
    if "events" in args.sections:
        out["events"] = guarded("events", lambda: event_times(torch, smi))
    if "fused" in args.sections:
        out["fused"] = guarded("fused", lambda: fused_library_times(torch, smi))
    for section, fn in (("train_profile", train_profiles), ("f32_profile", f32_profiles)):
        if section in args.sections:
            out[section] = guarded(section, lambda fn=fn: fn(torch))
            print(f"[{section}] {smi}: " + json.dumps(out[section]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    summary = {
        "bench_res_kernel": {k: v and {"xla": v["row"]["xla_ms_per_batch"], "fused": v["row"]["fused_ms_per_batch"],
                                       "model": v["model_ms"], "device_ms": v["device_ms"]}
                             for k, v in out.get("bench_res_kernel", {}).items()},
        "microbench": {k: v and v["ms"] for k, v in out.get("microbench", {}).items()},
        "prof_fwd": {k: v and v[-1] for k, v in out.get("prof_fwd", {}).items()},
        "prof_train": {k: v and v[-1] for k, v in out.get("prof_train", {}).items()},
        "fused": {k: v and {b: {leg: t for leg, t in r.items() if not leg.endswith(("_s", "_eager", "_error"))}
                            for b, r in v.items()} for k, v in (out.get("fused") or {}).items()},
        "failed": out["failed"],
    }
    print(json.dumps(summary))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
