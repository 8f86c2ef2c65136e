"""Host ms per search inside the port's ``stream_detect`` span: detection on the host over the smoothed
posteriors. Read under the profiler, so it holds the profiler's own cost per op."""


def read(r):
    n = r.counters.get("traced_units")
    ranges = r.trace.spans.get("stream_detect", [])
    return sum(e - s for s, e in ranges) * 1e-6 / n if n and ranges else None
