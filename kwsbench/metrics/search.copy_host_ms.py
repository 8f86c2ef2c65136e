"""Host ms per search inside the port's ``stream_copy`` span: the waveform's pageable copy to the card, which
holds the host until the copy is done. Read under the profiler, so it holds the profiler's own cost per op."""


def read(r):
    n = r.counters.get("traced_units")
    ranges = r.trace.spans.get("stream_copy", [])
    return sum(e - s for s, e in ranges) * 1e-6 / n if n and ranges else None
