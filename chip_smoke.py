#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (honk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA device and
nvcc. Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build both kernels (csrc/mfcc.cu, csrc/res_stack.cu) with nvcc, in parallel;
3. MFCC kernel against its plain PyTorch version on the card, B=257
   (256 rows of seeded noise and one silent row, which must be exactly 0);
4. res-stack kernel against its plain version: zoo/res8.pt weights at
   B=256 and B=1, and random res8-narrow and res26-narrow weights at B=3
   (res26's maps take the global scratch path);
5. LabelService("res8", "zoo/res8.pt") on cuda against the same service
   on the CPU: evaluate_batch of 256 seeded utterances;
6. the main path: the HTTP server answers GET /labels and 8 POST /listen
   requests; each answer is checked against the CPU service, and each
   kernel's launch count must be exactly 8 over this phase; the same
   utterances then go through LabelService.evaluate alone, on the host
   clock, to split a request's time between HTTP and the service;
7. each kernel and its plain version timed with CUDA events at B=1 and
   B=256.

It prints a JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}. The port's package, never JAX, is imported.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "zoo", "res8.pt")
SEED = 0
BATCH = 256
N_LISTEN = 8
# Kernel against its plain version on the same card, both float32 with TF32 off.
# MFCC: the DFT sums 480 products in another order and the log turns that
# relative error into absolute error on each mel energy; 1e-4 is still 50x
# inside the 5e-3 gate against the float64 golden.
MFCC_TOL = dict(atol=1e-4, rtol=1e-4)
# Res stack: the reference's own gate for its res-stack kernel
# (tests/test_res_kernel.py, kernel against the XLA model in f32).
RES_TOL = dict(atol=5e-4, rtol=1e-3)
# Whole service, cuda against cpu: the checkpoint logit gate of the reference
# (tests/test_cross_runtime.py); probabilities of one answer within 1e-4.
LOGIT_ATOL = 2e-4
PROB_ATOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def close(got, ref, atol, rtol) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def peaks(name: str) -> tuple[float, float]:
    """(f32 FLOP/s outside the tensor cores, HBM bytes/s): NVIDIA's SXM data sheets."""
    if "H200" in name:
        return 67e12, 4.8e12
    return 67e12, 3.35e12  # H100 SXM


def bound(flops: float, nbytes: float, name: str) -> tuple[float, str]:
    f, b = peaks(name)
    t_ops, t_bytes = flops / f * 1e3, nbytes / b * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int) -> float:
    """Device time per call: CUDA events around `iters` calls queued behind a spin
    kernel, so the host's enqueue time is hidden and the calls run back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 400_000)  # ~200 us of spinning per queued call at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def post_json(url: str, obj) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.frontend import compute_mfccs
    from honk_tpu_torch.models import SpeechResModel, find_config
    from honk_tpu_torch.ops import _build, mfcc_kernel, res_kernel
    from honk_tpu_torch.serve import LabelService, serve

    dev = torch.device("cuda")
    use_full_f32()
    name = torch.cuda.get_device_name(0)

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. Build both kernels from the sources in this checkout, in parallel.
    t0 = time.perf_counter()
    logs = _build.build("mfcc", "res_stack")
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f} s ({', '.join(sorted(logs)) or 'already built'})")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {src}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    audio_np = (rng.standard_normal((BATCH + 1, 16000)) * 0.2).astype(np.float32)
    audio_np[-1] = 0.0
    audio = torch.from_numpy(audio_np).to(dev)

    # 3. MFCC kernel against its plain version.
    got = mfcc_kernel.mfcc(audio)
    ref = mfcc_kernel.mfcc_plain(audio)
    torch.cuda.synchronize()
    if got.shape != (BATCH + 1, 101, 40) or not torch.isfinite(got).all():
        fail(f"mfcc kernel: shape {tuple(got.shape)} or non-finite values")
    if not bool((got[-1] == 0).all()):
        fail("mfcc kernel: the silent row is not exactly 0")
    mfcc_err = max_err(got, ref)
    if not close(got, ref, **MFCC_TOL):
        fail(f"mfcc kernel disagrees with its plain version: max abs err {mfcc_err:.3e}")
    got1 = mfcc_kernel.mfcc(audio[:1].contiguous())
    if not close(got1, ref[:1], **MFCC_TOL):
        fail(f"mfcc kernel at B=1: max abs err {max_err(got1, ref[:1]):.3e}")
    print(f"[mfcc] B={BATCH + 1} max abs err {mfcc_err:.3e} (atol {MFCC_TOL['atol']}, "
          f"rtol {MFCC_TOL['rtol']}); silent row exactly 0; B=1 ok")

    # 4. Res-stack kernel against its plain version.
    svc = LabelService("res8", CHECKPOINT)  # device defaults to cuda
    with torch.inference_mode():
        feats = mfcc_kernel.mfcc_plain(audio[:BATCH])
        pooled = svc.model.stem(feats)
        packed = res_kernel.pack_res_params(svc.model)
        got = res_kernel.res_stack(pooled, *packed)
        ref = res_kernel.res_stack_plain(pooled, *packed)
        torch.cuda.synchronize()
        res_err = max_err(got, ref)
        if got.shape != (BATCH, 12) or not torch.isfinite(got).all():
            fail(f"res_stack kernel: shape {tuple(got.shape)} or non-finite values")
        if not close(got, ref, **RES_TOL):
            fail(f"res_stack kernel disagrees with its plain version: max abs err {res_err:.3e}")
        got1 = res_kernel.res_stack(pooled[:1].contiguous(), *packed)
        if not close(got1, ref[:1], **RES_TOL):
            fail(f"res_stack kernel at B=1: max abs err {max_err(got1, ref[:1]):.3e}")
        # Random weights with randomized BN stats: res8-narrow (19 maps, shared
        # memory) and res26-narrow (50x20 maps do not fit: global scratch path).
        other_errs = {}
        for conf in ("res8-narrow", "res26-narrow"):
            cfg = find_config(conf)
            torch.manual_seed(SEED)
            m = SpeechResModel(cfg)
            for i in range(1, cfg["n_layers"] + 1):
                bn = getattr(m, f"bn{i}")
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.0)
            m = m.to(dev).eval()
            pooled_m = m.stem(feats[:3])
            packed_m = res_kernel.pack_res_params(m)
            got_m = res_kernel.res_stack(pooled_m, *packed_m)
            ref_m = res_kernel.res_stack_plain(pooled_m, *packed_m)
            torch.cuda.synchronize()
            other_errs[conf] = max_err(got_m, ref_m)
            if not close(got_m, ref_m, **RES_TOL):
                fail(f"res_stack kernel, {conf} B=3: max abs err {other_errs[conf]:.3e}")
    print(f"[res_stack] res8 B={BATCH} max abs err {res_err:.3e} (atol {RES_TOL['atol']}, "
          f"rtol {RES_TOL['rtol']}); B=1 ok; B=3 max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in other_errs.items()))

    # 5. The service on cuda against the same service on the CPU.
    cpu = LabelService("res8", CHECKPOINT, device="cpu")
    utts = audio_np[:BATCH]
    gpu_logits = svc.logits(utts).cpu()
    cpu_logits = cpu.logits(utts)
    logit_err = max_err(gpu_logits, cpu_logits)
    if logit_err > LOGIT_ATOL:
        fail(f"LabelService cuda vs cpu: logits max abs err {logit_err:.3e} > {LOGIT_ATOL}")
    gpu_out, cpu_out = svc.evaluate_batch(utts), cpu.evaluate_batch(utts)
    if [lab for lab, _ in gpu_out] != [lab for lab, _ in cpu_out]:
        fail("LabelService cuda vs cpu: labels differ")
    print(f"[service] evaluate_batch B={BATCH}: labels equal, logits max abs err {logit_err:.3e}")

    # 6. The main path: HTTP /listen through both kernels.
    requests = [
        (rng.standard_normal(n) * 3000).astype(np.int16)
        for n in (16000, 12000, 20000, 16000, 8000, 16000, 24000, 16000)
    ]
    mfcc_kernel.launches = 0
    res_kernel.launches = 0
    httpd = serve(svc, port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/labels", timeout=60) as r:
            if json.loads(r.read())["labels"] != svc.labels:
                fail("GET /labels: wrong labels")
        answers, listen_s = [], []
        for pcm in requests:
            t0 = time.perf_counter()
            answers.append(post_json(f"{base}/listen",
                                     {"wav_data": base64.b64encode(pcm.tobytes()).decode()}))
            listen_s.append(time.perf_counter() - t0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    launches = {"mfcc": mfcc_kernel.launches, "res_stack": res_kernel.launches}
    if th.is_alive():
        fail("HTTP server thread did not stop")
    if launches != {"mfcc": N_LISTEN, "res_stack": N_LISTEN}:
        fail(f"/listen x{N_LISTEN} launched {launches}, expected {N_LISTEN} each")
    for pcm, ans in zip(requests, answers):
        label, prob = cpu.evaluate(pcm.astype(np.float32) / 32768.0)
        if ans["label"] != label or abs(ans["prob"] - prob) > PROB_ATOL:
            fail(f"/listen answered {ans}, the CPU service ({label}, {prob})")
        if ans["contains_command"] != (label not in ("__silence__", "__unknown__")):
            fail(f"/listen contains_command wrong: {ans}")
    # The same utterances through LabelService.evaluate alone (no HTTP, JSON or
    # base64), to split the host time of a /listen between front end and service.
    evaluate_s = []
    for pcm in requests:
        x = pcm.astype(np.float32) / 32768.0
        t0 = time.perf_counter()
        svc.evaluate(x)
        evaluate_s.append(time.perf_counter() - t0)
    print(f"[listen] {N_LISTEN} requests answered like the CPU service; launches {launches}; "
          f"host ms per request {[round(s * 1e3, 3) for s in listen_s]}; "
          f"per evaluate() alone {[round(s * 1e3, 3) for s in evaluate_s]}")

    # 7. Times at B=1 (one /listen) and B=256, kernel and plain version.
    with torch.inference_mode():
        a1, a256 = audio[:1].contiguous(), audio[:BATCH].contiguous()
        p1, p256 = pooled[:1].contiguous(), pooled
        times = {}
        for b, a, p, iters in ((1, a1, p1, 200), (BATCH, a256, p256, 20)):
            times[b] = {
                "mfcc": time_ms(torch, lambda: mfcc_kernel.mfcc(a), iters),
                "mfcc_plain": time_ms(torch, lambda: mfcc_kernel.mfcc_plain(a), iters),
                "res_stack": time_ms(torch, lambda: res_kernel.res_stack(p, *packed), iters),
                "res_stack_plain": time_ms(torch, lambda: res_kernel.res_stack_plain(p, *packed), iters),
            }

    C, H, W = pooled.shape[1:]
    L, n_lab = packed[0].shape[0], packed[3].shape[1]

    def mfcc_work(b):
        flops = 2 * b * 101 * (2 * 480 * 241 + 241 * 40 + 40 * 40)
        nbytes = 4 * (b * 16000 + b * 101 * 40 + 480 + 2 * 480 * 241 + 241 * 40 + 40 * 40)
        return flops, nbytes

    def res_work(b):
        flops = 2 * b * L * H * W * 9 * C * C + 2 * b * C * n_lab
        nbytes = 4 * (b * C * H * W + L * 9 * C * C + 2 * L * C + C * n_lab + n_lab + b * n_lab)
        return flops, nbytes

    kernels = []
    for kname, src, replaces, work, err in (
        ("mfcc", "honk_tpu_torch/ops/csrc/mfcc.cu", "honk_tpu/ops/mfcc_kernel.py:75", mfcc_work, mfcc_err),
        ("res_stack", "honk_tpu_torch/ops/csrc/res_stack.cu", "honk_tpu/ops/res_kernel.py:139", res_work, res_err),
    ):
        b256, by = bound(*work(BATCH), name)
        b1, by1 = bound(*work(1), name)
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err,
            "ms": times[BATCH][kname], "plain_ms": times[BATCH][kname + "_plain"],
            "bound_ms": b256, "bound_by": by, "library_ms": None, "batch": BATCH,
            "ms_b1": times[1][kname], "plain_ms_b1": times[1][kname + "_plain"],
            "bound_ms_b1": b1, "bound_by_b1": by1,
        })
    print(json.dumps({"build_s": build_s, "listen_host_ms": [s * 1e3 for s in listen_s],
                      "evaluate_host_ms": [s * 1e3 for s in evaluate_s]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
