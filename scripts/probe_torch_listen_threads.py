#!/usr/bin/env python3
"""Probe the host time of one /listen's service call on one NVIDIA GPU, by thread.

    python3 scripts/probe_torch_listen_threads.py

The port's HTTP server (``ThreadingHTTPServer``) answers each connection on
a new thread; the service runs its device work on a worker thread of its
own (``serve/worker.py``), whichever thread calls it. For res8
(``zoo/res8.pt``), res15 and cnn-trad-pool2 (``zoo_hard_v2/``), this times
``LabelService.evaluate`` of one utterance on the host clock (each call
ends in a copy of the answer to the host) three ways: on the main thread,
on a new thread per call (as the server calls it), and on one caller thread
that makes every call; then the server path, ``POST /listen`` on a new
HTTP connection per request: its round trip, and the service call inside
it on the handler's thread. The columns are taken in turns, one call each
a round, over ``CALLS`` rounds. It prints the card's name and power limit
first, then a JSON line of the median and the spread of each. Needs a CUDA
device and nvcc; imports nothing of JAX.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 40
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


def columns(svc, serve, x: np.ndarray, worker: ThreadPoolExecutor) -> dict:
    """``CALLS`` rounds, each one call per column in turn (a drift of the
    shared host moves every column alike): ``evaluate`` on the main thread,
    on a new thread, on the one worker thread, and ``POST /listen`` on a
    new connection with the service call inside it."""
    body = json.dumps({"wav_data": base64.b64encode(np.round(x * 32767).astype(np.int16).tobytes()).decode()})
    inside = []
    evaluate = svc.evaluate
    call = lambda: evaluate(x)  # noqa: E731

    def evaluate_timed(audio):
        t0 = time.perf_counter()
        try:
            return evaluate(audio)
        finally:
            inside.append((time.perf_counter() - t0) * 1e3)

    for _ in range(3):  # warm up, on the main thread and on the worker
        call()
        worker.submit(call).result()
    httpd = serve(svc, port=0, enable_training=False, n_stream_slots=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    svc.evaluate = evaluate_timed
    url = f"http://127.0.0.1:{httpd.server_address[1]}/listen"

    def post():
        req = urllib.request.Request(url, data=body.encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:  # a new connection, so a new server thread
            r.read()

    cols = {k: [] for k in ("main_thread", "new_thread_per_call", "one_worker_thread", "http_listen_new_connection")}
    try:
        post()  # warm up the server path
        inside.clear()
        for _ in range(CALLS):
            cols["main_thread"].append(timed(call))
            cols["new_thread_per_call"].append(on_new_thread(call))
            cols["one_worker_thread"].append(worker.submit(timed, call).result())
            cols["http_listen_new_connection"].append(timed(post))
    finally:
        del svc.evaluate
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    cols["service_call_in_http_listen"] = inside
    return {k: summary(v) for k, v in cols.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from honk_tpu_torch.serve import LabelService, serve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    x = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32)
    with ThreadPoolExecutor(max_workers=1) as worker:
        results = {name: columns(LabelService(name, os.path.join(ROOT, path)), serve, x, worker)
                   for name, path in MODELS}
    print(json.dumps({"calls": CALLS, "evaluate_host_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
