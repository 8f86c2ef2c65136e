"""Device ms of what the port's ``conv_weight_grad`` spans launched (a bf16 conv's weight gradient: the
cotangent's cast, im2col, the float32 copy, the ``bmm``), per step."""


def read(r):
    n = r.counters.get("traced_units")
    acts = r.trace.in_span("conv_weight_grad")
    return sum(e - s for _, _, s, e, _ in acts) * 1e-6 / n if n and acts else None
