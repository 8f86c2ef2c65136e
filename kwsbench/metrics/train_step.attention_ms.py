"""Device ms of what the port's ``attention`` spans launched (the attention core, softmax(q k^T / sqrt(d)) v,
forward and backward), per step."""


def read(r):
    n = r.counters.get("traced_units")
    acts = r.trace.in_span("attention")
    return sum(e - s for _, _, s, e, _ in acts) * 1e-6 / n if n and acts else None
