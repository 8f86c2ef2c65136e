"""A traced slice of work and its reduction: device busy time, kernels by name, the kernels a span launched,
host-to-device copies, and the breakdown of device operations and idle gaps.

The slice runs under ``torch.profiler`` (CPU and CUDA activities), which
exports it as a Chrome trace; the reduction reads its events by category.
Device activities are kernels, copies and sets (``kernel``,
``gpu_memcpy``, ``gpu_memset``); a kernel belongs to the span (a
``record_function`` range of the port, such as ``train_step``) inside which
the host launched it, matched through the launch's ``correlation`` id.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 200 characters."""
    return name.split("(", 1)[0][:200] if "(" in name and not name.startswith("(") else name[:200]


class Trace:
    """The events of one traced slice (a Chrome trace's ``traceEvents``, times in us), and its length on the
    host's clock, ``window_s``."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device: list[tuple[str, str, int, int, int]] = []  # (kind, name, start, end, correlation), ns
        self.spans: dict[str, list[tuple[int, int]]] = defaultdict(list)
        self.host_ops: list[tuple[int, int, str]] = []  # the host's ops and spans, for the idle gaps
        launches: dict[int, int] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            kind, start = e.get("cat"), int(float(e["ts"]) * 1e3)
            end, corr = start + int(float(e.get("dur", 0)) * 1e3), e.get("args", {}).get("correlation")
            if kind in DEVICE_KINDS:
                self.device.append((kind, e["name"], start, end, corr))
            elif kind in LAUNCH_KINDS and corr is not None:
                launches[corr] = start
            elif kind in ("user_annotation", "cpu_op"):
                if kind == "user_annotation":
                    self.spans[e["name"]].append((start, end))
                self.host_ops.append((start, end, e["name"]))
        self.launched_at = {c: launches.get(c) for *_, c in self.device}
        self.device.sort(key=lambda d: d[2])

    def busy_intervals(self, skip: str | None = None) -> list[tuple[int, int]]:
        """The union of the device activities' intervals, in order (leaving out kernels named with ``skip``)."""
        merged: list[list[int]] = []
        for kind, name, s, e, _ in self.device:
            if skip is not None and kind == "kernel" and skip in name:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, skip: str | None = None) -> float:
        """Seconds in which some device activity ran (leaving out kernels whose name contains ``skip``)."""
        return sum(e - s for s, e in self.busy_intervals(skip)) * 1e-9

    def kernels(self, contains: str) -> list[float]:
        """Durations in ms of the kernels whose name contains ``contains``."""
        return [(e - s) * 1e-6 for kind, name, s, e, _ in self.device if kind == "kernel" and contains in name]

    def copies(self, contains: str) -> list[float]:
        """Durations in ms of the copies whose name contains ``contains`` (e.g. ``HtoD``)."""
        return [(e - s) * 1e-6 for kind, name, s, e, _ in self.device if kind == "gpu_memcpy" and contains in name]

    def in_span(self, span: str) -> list[tuple[str, str, int, int, int]]:
        """The device activities launched from inside a ``span`` range."""
        ranges = sorted(self.spans.get(span, []))
        starts = [s for s, _ in ranges]
        out = []
        for d in self.device:
            t = self.launched_at.get(d[4])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                out.append(d)
        return out

    def n_spans(self, span: str) -> int:
        return len(self.spans.get(span, []))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle gaps by the innermost host op
        running at each gap's start (seconds summed by name)."""
        ops: dict[str, float] = defaultdict(float)
        for _, name, s, e, _ in self.device:
            ops[short(name)] += (e - s) * 1e-9
        host = sorted(self.host_ops)
        starts = [s for s, _, _ in host]
        gaps: dict[str, float] = defaultdict(float)
        busy = self.busy_intervals()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(starts, a) - 1
            inner, stop = "no host op", max(-1, i - 5000)
            while i > stop:  # the latest-starting op still running at ``a``
                if host[i][1] >= a:
                    inner = host[i][2]
                    break
                i -= 1
            gaps[inner] += (b - a) * 1e-9
        best = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}


@contextlib.contextmanager
def traced(sync):
    """Trace the block; yields a list that holds the ``Trace`` once the block is over. ``sync`` waits for the
    device before the profiler starts and at both ends of the slice, so every device activity in the trace
    is the slice's and the slice's length is the device's. The Chrome trace goes through a file in the
    temporary directory, removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: list[Trace] = []
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    sync()
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        yield out
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.append(Trace(events, window))
