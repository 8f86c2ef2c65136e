"""Device ms of what the port's ``stream_forward`` span launched (the windows' eval forward and softmax), per
search."""


def read(r):
    n = r.counters.get("traced_units")
    acts = r.trace.in_span("stream_forward")
    return sum(e - s for _, _, s, e, _ in acts) * 1e-6 / n if n and acts else None
