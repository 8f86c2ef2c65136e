#!/usr/bin/env python3
"""Probe the host time of one /listen's service call on one NVIDIA GPU, by thread.

    python3 scripts/probe_torch_listen_threads.py

The port's HTTP server (``ThreadingHTTPServer``) answers each connection on
a new thread. For res8 (``zoo/res8.pt``), res15 and cnn-trad-pool2
(``zoo_hard_v2/``), this times ``LabelService.evaluate`` of one utterance on
the host clock (each call ends in a copy of the answer to the host) three
ways: on the main thread, on a new thread per call (as the server runs it),
and on one worker thread that takes every call. It prints the card's name
and power limit first, then a JSON line of the median and the spread of
each. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20
MODELS = (("res8", "zoo/res8.pt"), ("res15", "zoo_hard_v2/res15.pt"),
          ("cnn-trad-pool2", "zoo_hard_v2/cnn-trad-pool2.pt"))


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def on_new_thread(fn) -> float:
    out = []
    th = threading.Thread(target=lambda: out.append(timed(fn)))
    th.start()
    th.join(timeout=60)
    if th.is_alive() or not out:
        raise RuntimeError("a probe thread did not finish")
    return out[0]


def summary(ms: list[float]) -> dict:
    q = np.percentile(ms, [25, 50, 75])
    return {"median_ms": float(q[1]), "q25_ms": float(q[0]), "q75_ms": float(q[2]), "max_ms": max(ms)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from honk_tpu_torch.serve import LabelService

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    x = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32)
    results = {}
    with ThreadPoolExecutor(max_workers=1) as worker:
        for name, path in MODELS:
            svc = LabelService(name, os.path.join(ROOT, path))
            call = lambda: svc.evaluate(x)  # noqa: E731
            for _ in range(3):  # warm up, on the main thread and on the worker
                call()
                worker.submit(call).result()
            results[name] = {
                "main_thread": summary([timed(call) for _ in range(CALLS)]),
                "new_thread_per_call": summary([on_new_thread(call) for _ in range(CALLS)]),
                "one_worker_thread": summary([worker.submit(timed, call).result() for _ in range(CALLS)]),
            }
    print(json.dumps({"calls": CALLS, "evaluate_host_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
