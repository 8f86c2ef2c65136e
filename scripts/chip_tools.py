#!/usr/bin/env python3
"""The port's measuring tools at full length on one card, each beside its links' device time.

    python3 scripts/chip_tools.py [--serve_runs 3] [--serve_seconds 60] [--stream_runs 3] [--smoke] [--out <file>]

Needs a CUDA device. Builds the three kernels, then:

1. ``python -m honk_tpu_torch.cli.bench`` at its defaults (bf16 res8, B=256,
   scans of 32 / 160 train links and 64 / 320 inference links, 7 reps): its
   line. Then the same links under ``torch.profiler`` (20 inference links, 10
   train links, each its own chain): device ms and kernels per link, and the
   device's idle share against the bench's marginal host ms per link.
2. ``cli.bench_stream`` at 256 streams of 3,200 samples, ``--stream_runs``
   times; the profiler over 20 of its steps.
3. ``cli.bench_serve`` at its defaults (64 slots, 4 gateways, push_bin),
   with ``--json`` and with ``--pipelined``, ``--serve_runs`` times each in
   turns, ``--serve_seconds`` a run; the slab step at 64 slots (masked, the
   hub's) under the profiler, and each run's device busy share:
   dispatches x that step's device ms over the run's seconds.

``--smoke`` runs chip_smoke.py's phases 36-39 alone first (the tools at
short knobs, launches counted). Prints the card's name and power limit,
one line per reading, and a JSON summary as the last line (every reading
in ``--out``, where given); exits 1 if a tool fails.
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

SERVE_MODES = {"push_bin": [], "json": ["--json"], "pipelined": ["--pipelined"]}


def profile_bench(torch, row: dict) -> dict:
    """Device ms per inference and train link of the bench's own setup, and the idle share."""
    from honk_tpu_torch.cli import bench

    knobs = bench.settings()
    dev = torch.device("cuda")
    batch = knobs["batch"]
    rng = np.random.default_rng(0)
    model = bench.make_model(knobs["model"], knobs["dtype"], dev)
    pool = bench.make_pool(rng, batch, dev)
    link = bench.make_infer_link(model, pool, batch)
    acc = [torch.zeros((), device=dev)]
    i = [0]

    def infer():
        acc[0] = link(i[0], acc[0])
        i[0] += 1

    for _ in range(5):
        infer()
    out = {"infer": C.profile_steps(torch, infer, 20)}
    pool_n = pool.shape[0]
    del pool, link
    train = bench.make_train_run(model, rng, batch, pool_n, (1,), dev)
    for _ in range(3):
        train(1, 0.0)
    out["train"] = C.profile_steps(torch, lambda: train(1, 0.0), 10)
    for mode, rate in (("infer", row["infer_audio_s_per_s"]), ("train", row["train_audio_s_per_s"])):
        host_ms = 1e3 * batch / rate
        out[mode]["bench_marginal_ms"] = host_ms
        out[mode]["idle_share_vs_marginal"] = max(0.0, 1 - out[mode]["device_ms"] / host_ms)
    torch.cuda.empty_cache()
    return out


def profile_stream(torch) -> dict:
    from honk_tpu_torch.cli import bench_stream

    knobs = bench_stream.settings()
    dev = torch.device("cuda")
    bs = bench_stream.make_streamer(knobs["model"], knobs["n_streams"], knobs["chunk"], dev)
    chunks = torch.from_numpy((np.random.default_rng(0).standard_normal((knobs["n_streams"], knobs["chunk"]))
                               * 0.1).astype(np.float32)).to(dev)
    state = [bs.reset()]

    def step():
        state[0], _ = bs.process(state[0], chunks)

    for _ in range(5):
        step()
    return C.profile_steps(torch, step, 20)


def profile_slab(torch, slots: int = 64, chunk: int = 3200) -> dict:
    """The hub's slab step (every slot masked in) of the serving bench's float32 service."""
    from honk_tpu_torch.serve import LabelService

    svc = LabelService("res8", os.path.join(C.HARD_V2, "res8.pt"))
    bs = svc.make_batch_streamer(slots, chunk_samples=chunk)
    chunks = (np.random.default_rng(0).standard_normal((slots, chunk)) * 0.1).astype(np.float32)
    mask = np.ones((slots,), bool)
    state = [bs.reset()]

    def step():
        with torch.no_grad():
            state[0], _ = bs.process(state[0], chunks, mask)

    for _ in range(5):
        step()
    return C.profile_steps(torch, step, 20)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--serve_runs", type=int, default=3)
    p.add_argument("--serve_seconds", type=float, default=60.0)
    p.add_argument("--stream_runs", type=int, default=3)
    p.add_argument("--smoke", action="store_true", help="chip_smoke.py's phases 36-39 first")
    p.add_argument("--out", default="", help="a JSON file for every reading")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_tools: no CUDA device is available", file=sys.stderr)
        return 1
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.cli import bench, bench_serve, bench_stream
    from honk_tpu_torch.ops import _build, assemble_kernel, mfcc_kernel, res_kernel

    use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {os.cpu_count()} host cores", flush=True)
    t0 = time.perf_counter()
    _build.build("mfcc", "res_stack", "assemble")
    out = {"smi": smi, "host_cores": os.cpu_count(), "build_s": time.perf_counter() - t0, "failed": []}
    if args.smoke:
        counters = {"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel}
        t1 = time.perf_counter()
        out["smoke"] = C.phase_tools(torch, counters, smi)
        out["smoke_s"] = time.perf_counter() - t1

    def tool(name: str, main, argv: list[str]) -> dict | None:
        t1 = time.perf_counter()
        try:
            rc, text = C.run_cli(main, argv)
        except Exception as e:  # noqa: BLE001 - recorded, and the next reading runs
            rc, text = 1, f"{type(e).__name__}: {e}"
        rows = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
        if rc != 0 or len(rows) != 1:
            out["failed"].append(f"{name} {argv}: rc {rc}, {text[-1500:]}")
            print(f"[{name}] FAILED rc {rc}: {text[-1500:]}", flush=True)
            return None
        row = {**rows[0], "wall_s": time.perf_counter() - t1}
        print(f"[{name}] {smi}: {json.dumps(row)}", flush=True)
        return row

    row = tool("bench", bench.main, [])
    out["bench"] = {"row": row}
    torch.cuda.empty_cache()
    if row is not None:
        out["bench"]["profile"] = prof = profile_bench(torch, row)
        print(f"[bench_profile] {smi}: {json.dumps(prof)}", flush=True)

    out["bench_stream"] = {"rows": [tool("bench_stream", bench_stream.main, []) for _ in range(args.stream_runs)],
                           "profile": profile_stream(torch)}
    print(f"[bench_stream_profile] {smi}: {json.dumps(out['bench_stream']['profile'])}", flush=True)
    torch.cuda.empty_cache()

    slab = profile_slab(torch)
    print(f"[slab_profile] {smi}: {json.dumps(slab)}", flush=True)
    serve = {mode: [] for mode in SERVE_MODES}
    checkpoint = os.path.join(C.HARD_V2, "res8.pt")
    for _ in range(args.serve_runs):
        for mode, flags in SERVE_MODES.items():
            row = tool(f"bench_serve {mode}", bench_serve.main,
                       ["--seconds", str(args.serve_seconds), "--checkpoint", checkpoint, *flags])
            if row is not None:
                row["device_busy_share"] = row["dispatches"] * slab["device_ms"] / 1e3 / row["seconds"]
            serve[mode].append(row)
    summary = {}
    for mode, rows in serve.items():
        vals = sorted(r["value"] for r in rows if r is not None)
        if vals:
            summary[mode] = {"min": vals[0], "median": float(np.median(vals)), "max": vals[-1], "n": len(vals)}
    out["bench_serve"] = {"slab_profile": slab, "runs": serve, "streams": summary}
    print(f"[bench_serve] {smi}: streams min/median/max {json.dumps(summary)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"bench": out["bench"]["row"], "bench_stream": [r and r["step_ms"] for r in
                                                                     out["bench_stream"]["rows"]],
                      "bench_serve": summary, "failed": out["failed"]}))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
